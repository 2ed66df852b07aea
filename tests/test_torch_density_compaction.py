"""render_rays' density over the whole lattice gated by an alpha mask,
compacted to the slots the mask admits, against the dense formula: the
density on every slot, ``where`` on the gated validity, the weights, the
shading of every slot gated by the weight threshold.

Each model (TensorVMSplit, TensorCP, TensorVM), fused and unfused
gathers, world and NDC rays, and a mask that admits no slot, every slot in
the box or a few.  Sigma, weights, rgb, depth, acc and every parameter's
gradient agree to float32 round-off; with no slot admitted the density
factors still get (zero) gradients, as in the dense formula.  The render
counts ``render.density_rows`` as the rows the density ran on: the admitted
slots here, rays x width where a budget compacted the slots first or no
mask gates the lattice.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensorf_tpu_torch.models import FIELD_MODELS, ModelConfig
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.models.shading import apply_shading
from tensorf_tpu_torch.ops.freq_mask import FreeMasks
from tensorf_tpu_torch.ops.rays import sample_along_rays, sample_along_rays_ndc
from tensorf_tpu_torch.ops.render_math import raw2alpha
from tensorf_tpu_torch.render import render_rays
from tensorf_tpu_torch.render.volume import feature2density, normalize_coord
from tensorf_tpu_torch.utils import tracing

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
GRID = (20, 22, 24)
MASK_GRID = (12, 13, 14)  # (Z, Y, X)
B = 64
STEP = 0.05
MODELS = {
    "TensorVMSplit": dict(density_n_comp=(3, 2, 2), app_n_comp=(4, 3, 3), app_dim=6,
                          shading_mode="MLP_Fea", view_pe=2, fea_pe=2),
    "TensorCP": dict(density_n_comp=(4,), app_n_comp=(6,), app_dim=9, shading_mode="MLP",
                     pos_pe=2, view_pe=2, fea_pe=2),
    "TensorVM": dict(density_n_comp=(4,), app_n_comp=(6,), app_dim=27, shading_mode="SH"),
}
# world rays from a sphere of radius 4 into the cube; NDC rays as an LLFF
# loader leaves them (origins on z = -1, some leaving through the sides)
GEOMETRY = {
    False: dict(aabb=[[-1.5] * 3, [1.5] * 3], near_far=(2.0, 6.0), n_samples=96),
    True: dict(aabb=[[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], near_far=(0.0, 1.0), n_samples=48),
}


def _mask(aabb, admits):
    """An alpha mask over ``aabb`` whose gate admits no slot, every slot in
    the box, or those near a few occupied voxels (dilated 3x3x3)."""
    vol = torch.zeros(MASK_GRID)
    if admits == "all":
        vol += 1.0
    elif admits == "few":
        for z, y, x in ((3, 4, 5), (6, 6, 6), (8, 9, 7), (5, 8, 10)):
            vol[z, y, x] = 1.0
    return tam.with_dilation(tam.AlphaGridMask(aabb, vol))


def _case(model, ndc):
    rng = np.random.default_rng(3)
    geo = GEOMETRY[ndc]
    cfg = ModelConfig(model_name=model, feature_c=16, fea2dense_act="relu",
                      near_far=geo["near_far"], **MODELS[model])
    field = FIELD_MODELS[model](cfg, GRID, "cpu", torch.Generator().manual_seed(5))
    if ndc:
        o = np.concatenate([rng.uniform(-1.2, 1.2, size=(B, 2)), -np.ones((B, 1))], -1)
        d = np.concatenate([rng.uniform(-0.8, 0.8, size=(B, 2)), 2.0 * np.ones((B, 1))], -1)
    else:
        o = rng.normal(size=(B, 3))
        o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(B, 3))
    rays = torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))
    n = geo["n_samples"]
    noise = torch.from_numpy(rng.uniform(size=(B, n if ndc else 1)).astype(np.float32))
    # FreeNeRF rank masks on the density and appearance factors
    masks = FreeMasks(den=tuple(torch.linspace(1.0, 0.5, r) for r in cfg.density_n_comp),
                      app=tuple(torch.linspace(1.0, 0.25, r) for r in cfg.app_n_comp))
    cot = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    return field, rays, noise, masks, torch.tensor(geo["aabb"]), n, cot


def _dense(field, rays, noise, masks, aabb, n, ndc, fused, mask):
    """(rgb, depth, acc, weights, sigma, admitted slots) with the density
    and the shading on every slot."""
    cfg = field.cfg
    near, far = cfg.near_far
    o, d = rays[:, :3], rays[:, 3:6]
    if ndc:
        xyz, z, valid = sample_along_rays_ndc(o, d, aabb, near, far, n, noise)
    else:
        xyz, z, valid = sample_along_rays(o, d, aabb, near, far, STEP, n, noise)
    valid = valid & (tam.sample_alpha_gate(mask, xyz) > 0)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], dim=-1)
    if ndc:
        norm = torch.linalg.norm(d, dim=-1, keepdim=True)
        dists, d = dists * norm, d / norm
    pts = normalize_coord(xyz, aabb).reshape(-1, 3)
    if fused:
        den = field.density_feature_fused(pts, masks.den)
        app = field.app_feature_fused(pts, masks.app)
    else:
        den, app = field.density_feature(pts, masks.den), field.app_feature(pts, masks.app)
    sigma = torch.where(valid, feature2density(cfg, den.reshape(B, n)), 0.0)
    _, weight, _ = raw2alpha(sigma, dists * cfg.distance_scale)
    gate = weight > cfg.ray_march_weight_thres
    view = d[:, None, :].expand(B, n, 3).reshape(-1, 3)
    rgb_s = apply_shading(cfg, field.render, pts, view, app, masks).reshape(B, n, 3)
    rgb = torch.sum(weight[..., None] * torch.where(gate[..., None], rgb_s, 0.0), dim=-2)
    acc = torch.sum(weight, dim=-1)
    rgb = torch.clamp(rgb + (1.0 - acc[..., None]), 0.0, 1.0)  # white background
    depth = torch.sum(weight * z, dim=-1) + (1.0 - acc) * rays[:, -1]
    return rgb, depth.detach(), acc, weight, sigma, int(torch.sum(valid))


def _grads(field, loss):
    field.zero_grad(set_to_none=True)
    loss.backward()
    grads = {name: p.grad for name, p in field.named_parameters()}
    missing = [name for name, g in grads.items() if g is None]
    assert not missing, f"no gradient reached {missing}"
    return {name: g.clone() for name, g in grads.items()}


def _counted_render(*args, **kwargs):
    """render_rays under a profiler: (output, the render's counters)."""
    tracing.take_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = render_rays(*args, **kwargs)
    return out, tracing.take_counts()


@pytest.mark.parametrize("admits", ["none", "all", "few"])
@pytest.mark.parametrize("ndc", [False, True], ids=["world", "ndc"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("model", list(MODELS))
def test_compacted_density_equals_the_dense_formula(model, fused, ndc, admits):
    field, rays, noise, masks, aabb, n, cot = _case(model, ndc)
    mask = _mask(aabb, admits)
    # a threshold that some weights pass where the mask admits any slot
    with torch.no_grad():
        weight = _dense(field, rays, noise, masks, aabb, n, ndc, fused, mask)[3]
    field.cfg = dataclasses.replace(field.cfg, ray_march_weight_thres=min(
        1e-4, 0.5 * float(torch.max(weight))) if admits != "none" else 1e-4)

    want = _dense(field, rays, noise, masks, aabb, n, ndc, fused, mask)
    want_grads = _grads(field, torch.sum(want[0] * cot))
    kw = dict(u=noise) if not ndc else dict(jitter=noise)
    got, counts = _counted_render(field, rays, masks, aabb=aabb, step_size=STEP, n_samples=n,
                                  is_train=True, white_bg=True, ndc_ray=ndc, fused=fused,
                                  alpha_mask=mask, **kw)
    got_grads = _grads(field, torch.sum(got.rgb * cot))

    admitted = want[5]
    if admits == "none":
        assert admitted == 0
    elif admits == "few":
        assert 0 < admitted < B * n // 4
    else:
        assert admitted > B * n // 4
    assert counts["render.density_rows"] == admitted
    assert counts["render.alive"] == pytest.approx(admitted, rel=1e-6)
    assert got.sigma.shape == got.weights.shape == (B, n)
    assert not torch.any(got.sigma[want[4] == 0.0] != 0.0)
    for name, a, b in zip(("rgb", "depth", "acc", "weights"), got[:4], want[:4]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), err_msg=name, **OUT)
    np.testing.assert_allclose(got.sigma.detach().numpy(), want[4].detach().numpy(),
                               err_msg="sigma", **OUT)
    for name, g in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), g.numpy(), err_msg=name, **GRAD)
    if admits == "none":
        assert int(got.num_valid_samples) == 0
        assert all(not torch.any(got_grads[name]) for name in got_grads)
    else:
        assert int(got.num_valid_samples) > 0


@pytest.mark.parametrize("budget", ["cand", "alive", "no_mask"])
def test_budgeted_and_mask_free_renders_stay_dense(budget):
    """A render whose budget packed the slots (the strata's "cand" mode,
    the unstratified "alive" mode) and a whole-lattice render with no mask
    run the density on rays x width slots, as before."""
    field, rays, noise, masks, aabb, n, _ = _case("TensorVMSplit", False)
    mask = _mask(aabb, "few")
    K = 32  # a COARSE_STRIDE multiple below the lattice
    kw = dict(no_mask=dict(), cand=dict(alpha_mask=mask, sample_budget=K, budget_mode="cand"),
              alive=dict(alpha_mask=mask, sample_budget=K, budget_mode="alive"))[budget]
    got, counts = _counted_render(field, rays, masks, aabb=aabb, step_size=STEP, n_samples=n,
                                  is_train=True, white_bg=True, u=noise, **kw)
    width = n if budget == "no_mask" else K
    assert got.sigma.shape == (B, width)
    assert counts["render.density_rows"] == B * width
    assert counts["render.alive"] < B * width
