"""render_rays' shading without a top-K, compacted to the samples whose
weight passes ``ray_march_weight_thres``, against the dense formula:
features and the shading head on every slot, ``where`` on the gate, the
weighted sum.

Each model with its own head (TensorVMSplit MLP_Fea, TensorCP MLP with
positional encoding of the points, TensorVM SH), fused and unfused
gathers, world and NDC rays, and a gate that no sample, every sample or a
few samples pass.  Outputs and every parameter's gradient agree to float32
round-off; with no sample passing, the appearance factors and the head
still get (zero) gradients, as in the dense formula.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tensorf_tpu_torch.models import FIELD_MODELS, ModelConfig
from tensorf_tpu_torch.models.shading import apply_shading
from tensorf_tpu_torch.ops.freq_mask import FreeMasks
from tensorf_tpu_torch.ops.rays import sample_along_rays, sample_along_rays_ndc
from tensorf_tpu_torch.ops.render_math import raw2alpha
from tensorf_tpu_torch.render import render_rays
from tensorf_tpu_torch.render.volume import feature2density, normalize_coord

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
GRID = (20, 22, 24)
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


def _dense(field, rays, noise, masks, aabb, n, ndc, fused):
    """(rgb, depth, acc, weights, samples shaded) with every slot shaded."""
    cfg = field.cfg
    near, far = cfg.near_far
    o, d = rays[:, :3], rays[:, 3:6]
    if ndc:
        xyz, z, valid = sample_along_rays_ndc(o, d, aabb, near, far, n, noise)
    else:
        xyz, z, valid = sample_along_rays(o, d, aabb, near, far, STEP, n, noise)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], dim=-1)
    if ndc:
        norm = torch.linalg.norm(d, dim=-1, keepdim=True)
        dists, d = dists * norm, d / norm
    pts = normalize_coord(xyz, aabb).reshape(-1, 3)
    if fused:
        den, app = field.density_feature_fused(pts, masks.den), field.app_feature_fused(pts, masks.app)
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
    return rgb, depth.detach(), acc, weight, int(torch.sum(gate))


def _grads(field, loss):
    field.zero_grad(set_to_none=True)
    loss.backward()
    grads = {name: p.grad for name, p in field.named_parameters()}
    missing = [name for name, g in grads.items() if g is None]
    assert not missing, f"no gradient reached {missing}"
    return {name: g.clone() for name, g in grads.items()}


@pytest.mark.parametrize("gate", ["none", "all", "few"])
@pytest.mark.parametrize("ndc", [False, True], ids=["world", "ndc"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("model", list(MODELS))
def test_compacted_shading_equals_the_dense_formula(model, fused, ndc, gate):
    field, rays, noise, masks, aabb, n, cot = _case(model, ndc)
    with torch.no_grad():
        weight = _dense(field, rays, noise, masks, aabb, n, ndc, fused)[3]
    thres = {"none": 2.0, "all": -1.0, "few": float(torch.quantile(weight.flatten(), 0.97))}[gate]
    field.cfg = dataclasses.replace(field.cfg, ray_march_weight_thres=thres)

    want = _dense(field, rays, noise, masks, aabb, n, ndc, fused)
    want_grads = _grads(field, torch.sum(want[0] * cot))
    kw = dict(u=noise) if not ndc else dict(jitter=noise)
    got = render_rays(field, rays, masks, aabb=aabb, step_size=STEP, n_samples=n,
                      is_train=True, white_bg=True, ndc_ray=ndc, fused=fused, **kw)
    got_grads = _grads(field, torch.sum(got.rgb * cot))

    shaded = {"none": 0, "all": B * n}.get(gate, want[4])
    assert int(got.num_valid_samples) == want[4] == shaded
    if gate == "few":
        assert 0 < shaded < B * n // 10
    for name, a, b in zip(("rgb", "depth", "acc", "weights"), got[:4], want[:4]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), err_msg=name, **OUT)
    for name, g in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), g.numpy(), err_msg=name, **GRAD)
    if gate == "none":
        assert all(not torch.any(got_grads[name]) for name in got_grads
                   if name.startswith(("app", "basis", "render")))
