"""Parity of the port's NDC path and 1-D footprint line gather with
tensorf_tpu's.

The same seeded numpy inputs, and the jitter and background flip JAX draws
from its key, go through both packages: the NDC projections, ndc_bbox and
aabb_intersect (float32 1e-6; the projections' gradients 1e-5), the NDC
sampler (exact), render_rays on NDC rays with no mask, with a mask and
under each sample budget (outputs rtol/atol 1e-5, gradients 1e-4), the
chunked NDC fallback, the 1-D footprint gather (forward 1e-6, gradient
1e-5), one NDC train step's gradients (1e-4) and a 15-step loss curve
(1e-3 relative), and configs/flower.txt, tiny, through both CLIs on one
on-disk scene.
"""

import dataclasses
import json
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train as train_cli
from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models import alpha_mask as jam
from tensorf_tpu.models import tensorf as jtensorf
from tensorf_tpu.ops import grid_sample as jgs
from tensorf_tpu.ops import rays as jrays
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.render.chunked import render_chunked_stratified as j_chunked
from tensorf_tpu.train import LossWeights as JWeights
from tensorf_tpu.train import TrainStatics as JStatics
from tensorf_tpu.train import make_optimizer as j_make_optimizer
from tensorf_tpu.train import make_train_step as j_make_train_step
from tensorf_tpu.utils import ckpt as jckpt
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch import __main__ as cli
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.data.synthetic import make_forward_facing_scene, write_forward_facing_scene
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import TensorVMSplit
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.models import tensorf as ttensorf
from tensorf_tpu_torch.ops import grid_sample as tgs
from tensorf_tpu_torch.ops import rays as trays
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.ops.scatter_add import scatter_add_reference
from tensorf_tpu_torch.render import chunked as tchunked
from tensorf_tpu_torch.render import render_rays as t_render
from tensorf_tpu_torch.train import LossWeights as TWeights
from tensorf_tpu_torch.train import TrainStatics as TStatics
from tensorf_tpu_torch.train import loss_fn, make_optimizer
from tensorf_tpu_torch.utils import ckpt as tckpt

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
# data/llff.py's box and near/far
AABB = np.asarray([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32)
CFG = ModelConfig(
    model_name="TensorVMSplit", density_n_comp=(3, 2, 2), app_n_comp=(4, 3, 3), app_dim=6,
    shading_mode="MLP_Fea", pos_pe=0, view_pe=0, fea_pe=0, feature_c=16,
    fea2dense_act="relu", near_far=(0.0, 1.0),
)
GRID = (12, 13, 8)
NS = 48
JM = FIELD_MODELS["TensorVMSplit"]


def t(a):
    return torch.from_numpy(np.array(a))


def _flat(params):
    out = {}
    _flatten("", params, out)
    return {k.replace("/", "."): v for k, v in out.items()}


def jax_and_port(seed, cfg=CFG, grid=GRID):
    params = JM.init(jax.random.PRNGKey(seed), cfg, grid)
    field = TensorVMSplit(TConfig(**dataclasses.asdict(cfg)), grid, device="cpu")
    field.load_state_dict(params_from_jax(_flat(params)))
    return params, field


def ndc_rays(rng, n):
    """Rays as an LLFF scene's loader leaves them: origins on the NDC near
    plane z = -1, directions with z = 2 (near 1) and a small x, y slope;
    some leave the box through its side."""
    o = np.concatenate([rng.uniform(-1.2, 1.2, size=(n, 2)), -np.ones((n, 1))], -1)
    d = np.concatenate([rng.uniform(-0.8, 0.8, size=(n, 2)), 2.0 * np.ones((n, 1))], -1)
    return np.concatenate([o, d], -1).astype(np.float32)


def world_rays(rng, n):
    """Forward-facing world rays: origins near 0, looking down -z."""
    o = 0.2 * rng.normal(size=(n, 3))
    d = np.concatenate([rng.uniform(-0.5, 0.5, size=(n, 2)), -np.ones((n, 1))], -1)
    return o.astype(np.float32), d.astype(np.float32)


def noise(key, n, ns=NS):
    """The per-sample jitter and the flip JAX's render_rays draws from key."""
    k_strat, k_bg = jax.random.split(key)
    return (t(jax.random.uniform(k_strat, (n, ns), dtype=jnp.float32)),
            t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32)))


def both_masks(seed=7, occ=0.4):
    vol = (np.random.default_rng(seed).uniform(size=(8, 12, 10)) < occ).astype(np.float32)
    j = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(AABB), volume=jnp.asarray(vol)))
    p = tam.with_dilation(tam.AlphaGridMask(aabb=t(AABB), volume=t(vol)))
    return j, p


# ---- rays ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ndc_rays_blender", "ndc_rays"])
def test_ndc_projections_match_jax(rng, name):
    """numpy in, numpy out (the loader's path) and tensors in, tensors out,
    forward within 1e-6 and the gradients within 1e-5 of JAX's."""
    o, d = world_rays(rng, 200)
    if name == "ndc_rays":  # OpenCV convention: +z forward
        o, d = o * np.float32([1, 1, -1]), d * np.float32([1, 1, -1])
    args = (30, 40, 35.0, 1.0)
    j_fn, t_fn = getattr(jrays, name), getattr(trays, name)
    for got, want in zip(t_fn(*args, o, d), j_fn(*args, o, d)):
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    w_o, w_d = rng.normal(size=(2, 200, 3)).astype(np.float32)

    def j_loss(o_, d_):
        no, nd = j_fn(*args, o_, d_)
        return jnp.sum(no * w_o) + jnp.sum(nd * w_d)

    j_go, j_gd = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(d))
    to, td = t(o).requires_grad_(), t(d).requires_grad_()
    no, nd = t_fn(*args, to, td)
    np.testing.assert_allclose(no.detach().numpy(), np.asarray(j_fn(*args, jnp.asarray(o),
                                                                    jnp.asarray(d))[0]),
                               rtol=1e-6, atol=1e-6)
    (torch.sum(no * t(w_o)) + torch.sum(nd * t(w_d))).backward()
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(j_go), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(j_gd), rtol=1e-5, atol=1e-5)


def test_ndc_bbox_and_aabb_intersect_match_jax(rng):
    rays = ndc_rays(rng, 300)
    np.testing.assert_array_equal(trays.ndc_bbox(rays), jrays.ndc_bbox(rays))
    far = ndc_rays(rng, 300)
    far[::2, 0] += 3.0  # these miss the box
    far[::4, 3] = -1.5  # these turn back into it
    got = trays.aabb_intersect(t(far[:, :3]), t(far[:, 3:]), t(AABB)).numpy()
    want = np.asarray(jrays.aabb_intersect(jnp.asarray(far[:, :3]), jnp.asarray(far[:, 3:]),
                                           jnp.asarray(AABB)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("keyed", [False, True], ids=["eval", "jitter"])
def test_sample_along_rays_ndc_matches_jax(rng, keyed):
    rays = ndc_rays(rng, 64)
    key = jax.random.PRNGKey(3) if keyed else None
    want = jrays.sample_along_rays_ndc(jnp.asarray(rays[:, :3]), jnp.asarray(rays[:, 3:]),
                                       jnp.asarray(AABB), 0.0, 1.0, NS, key)
    jitter = t(jax.random.uniform(key, (64, NS), dtype=jnp.float32)) if keyed else None
    got = trays.sample_along_rays_ndc(t(rays[:, :3]), t(rays[:, 3:]), t(AABB), 0.0, 1.0, NS,
                                      jitter)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert got[2].any() and not got[2].all()


# ---- the renderer ----------------------------------------------------------------

# name: (masked, render_rays keywords)
MODES = {
    "no_mask": (False, {}),
    "mask": (True, {}),
    "budget_alive": (True, dict(sample_budget=24, budget_mode="alive")),
    "budget_exact_gate": (True, dict(sample_budget=24, budget_mode="cand",
                                     use_coarse_gate=False)),
    "budget_cand_windows": (True, dict(sample_budget=24, budget_mode="cand")),
    "budget_prefilter": (False, dict(sample_budget=24)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_render_rays_ndc_matches_jax(rng, mode):
    """Outputs rtol/atol 1e-5 (depth 1e-4), overflow and alive means equal,
    and the gradients of a weighted rgb sum 1e-4, with JAX's jitter and
    background flip (white_bg False: LLFF's black background)."""
    masked, extra = MODES[mode]
    params, field = jax_and_port(1)
    jmask, pmask = both_masks()
    rays = ndc_rays(rng, 64)
    key = jax.random.PRNGKey(5)
    jitter, flip = noise(key, 64)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    kw = dict(step_size=0.05, n_samples=NS, is_train=True, white_bg=False, ndc_ray=True,
              shade_top_k=16, fused=True, **extra)

    def j_loss(p):
        out = j_render(JM, CFG, p, jmask if masked else None, jnp.asarray(rays), key, JMasks(),
                       aabb=jnp.asarray(AABB), **kw)
        return jnp.sum(out.rgb * w), out

    (_, want), j_grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    got = t_render(field, t(rays), TMasks(), aabb=t(AABB), alpha_mask=pmask if masked else None,
                   jitter=jitter, flip=flip, **kw)
    np.testing.assert_allclose(got.rgb.detach().numpy(), np.asarray(want.rgb), **FWD)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-4, atol=1e-4)
    for name in ("weights", "sigma", "z_vals", "acc"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), err_msg=name, **FWD)
    assert float(got.budget_overflow_frac) == float(want.budget_overflow_frac)
    np.testing.assert_allclose(float(got.mean_alive_samples), float(want.mean_alive_samples),
                               rtol=1e-6)
    assert int(got.num_valid_samples) == int(want.num_valid_samples)
    assert got.z_vals.shape[1] == extra.get("sample_budget", NS)
    torch.sum(got.rgb * t(w)).backward()
    j_flat = _flat(j_grads)
    for name, p in field.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_flat[name], err_msg=name, **GRAD)


def test_chunked_ndc_fallback_matches_jax(rng):
    """render_chunked_stratified serves NDC rays uniform, unbudgeted and
    without the coarse gate, as the JAX package's serving does; a lattice above 512
    caps the chunk at 8192 rays."""
    params, field = jax_and_port(2)
    jmask, pmask = both_masks()
    rays = ndc_rays(rng, 256)  # whole chunks: JAX counts the shaded samples of its padding
    kw = dict(step_size=0.05, n_samples=NS, white_bg=False, ndc_ray=True, shade_top_k=16)
    want = j_chunked(JM, CFG, params, jmask, rays, jnp.asarray(AABB), chunk=128, **kw)
    got = tchunked.render_chunked_stratified(field, pmask, rays, t(AABB), chunk=128, **kw)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
    assert got[2:] == tuple(want[2:])

    chunks = []
    real = tchunked.render_chunked

    def spy(*a, chunk, **k):
        chunks.append((k["n_samples"], chunk))
        return real(*a, chunk=chunk, **k)

    with mock.patch.object(tchunked, "render_chunked", spy):
        for n_samples in (NS, 600):
            tchunked.render_chunked_stratified(field, pmask, rays[:4], t(AABB), chunk=16384,
                                               **dict(kw, n_samples=n_samples))
    assert chunks == [(NS, 16384), (600, 8192)]


# ---- the 1-D footprint line gather -----------------------------------------------


@pytest.mark.parametrize("L", [7, 1100])
def test_footprint_sample_1d_matches_jax_and_the_matmul(rng, L):
    line = rng.normal(size=(L, 5)).astype(np.float32)
    coord = rng.uniform(-1.05, 1.05, size=(300,)).astype(np.float32)
    g = rng.normal(size=(300, 5)).astype(np.float32)

    def j_loss(l):
        return jnp.sum(jgs.footprint_sample_1d(jgs.make_footprint_1d(l), L, jnp.asarray(coord))
                       * g)

    want = jgs.footprint_sample_1d(jgs.make_footprint_1d(jnp.asarray(line)), L,
                                   jnp.asarray(coord))
    tl = t(line).requires_grad_()
    calls = []

    def counting(idx, g_, n_rows):
        calls.append((g_.shape, n_rows))
        return scatter_add_reference(idx, g_, n_rows)

    with mock.patch.object(tgs, "scatter_add", counting):
        got = tgs.footprint_sample_1d(tgs.make_footprint_1d(tl), L, t(coord))
        torch.sum(got * t(g)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jax.grad(j_loss)(jnp.asarray(line))),
                               rtol=1e-5, atol=1e-5)
    # its backward is one row scatter-add into the (L, 2C) table
    assert calls == [(torch.Size([300, 10]), L)]
    np.testing.assert_allclose(got.detach().numpy(),
                               tgs.line_sample_matmul(t(line), t(coord)).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_line_dispatch_takes_the_footprint_above_its_bounds(monkeypatch):
    """The one-hot matmul while its (M, L) float32 matrix is within the
    byte bound and L <= 1024; the footprint gather above either.  Both
    give the same features, and only the footprint scatters."""
    assert ttensorf.line_uses_matmul(4_292_608, 345)  # synth_full's widest one-hot
    assert ttensorf.line_uses_matmul(4_231_168, 351)  # flower's third segment
    assert not ttensorf.line_uses_matmul(6_336_512, 315)  # flower's fourth
    assert not ttensorf.line_uses_matmul(10, 1025)
    _, field = jax_and_port(3)
    xyz = t(np.random.default_rng(0).uniform(-1, 1, size=(50, 3)).astype(np.float32))

    def run():
        calls = []

        def counting(idx, g, n_rows):
            calls.append(g.shape[1])
            return scatter_add_reference(idx, g, n_rows)

        field.zero_grad(set_to_none=True)
        with mock.patch.object(tgs, "scatter_add", counting):
            den = field.density_feature_fused(xyz, None)
            app = field.app_feature_fused(xyz, None)
            (den.sum() + app.sum()).backward()
        return den.detach(), app.detach(), calls

    den, app, calls = run()
    assert len(calls) == 6  # the three density and three appearance plane tables
    # a bound below 50 points x the shortest line (8) x 4 B: every line above it
    monkeypatch.setattr(ttensorf, "_ONE_HOT_MAX_BYTES", 50 * 7 * 4)
    f_den, f_app, f_calls = run()
    # the plane tables (4 taps x 3, 2, 2 density and 4, 3, 3 appearance
    # ranks), then the line tables (2 taps x the same)
    assert sorted(f_calls) == sorted([12, 8, 8, 16, 12, 12, 6, 4, 4, 8, 6, 6])
    np.testing.assert_allclose(f_den.numpy(), den.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f_app.numpy(), app.numpy(), rtol=1e-5, atol=1e-6)


def test_lines_over_1024_sample_as_jax_does(rng):
    """A packed line longer than 1024 takes JAX's footprint path in both."""
    line = rng.normal(size=(1100, 6)).astype(np.float32)
    coord = rng.uniform(-1, 1, size=(40,)).astype(np.float32)
    want = jtensorf._sample_line_packed(jnp.asarray(line), jnp.asarray(coord))
    got = ttensorf._sample_line_packed(t(line), t(coord))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---- training --------------------------------------------------------------------

STATICS = dict(n_samples=NS, step_size=0.05, white_bg=False, ndc_ray=True, total_steps=100,
               lr_factor=0.999, free_reg=False, shade_top_k=16, fused=True)
WEIGHTS = dict(tv_density=1.0, tv_app=1.0)


def _capture_grads():
    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


def test_one_ndc_step_gradients_match_jax(rng):
    """configs/flower.txt's step shape (relu density, TV on, black
    background with the random flip): every leaf's gradient within 1e-4."""
    params, field = jax_and_port(4)
    rays = ndc_rays(rng, 64)
    rgbs = rng.uniform(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    tx = _capture_grads()
    j_step = j_make_train_step(JM, CFG, JStatics(weights=JWeights(**WEIGHTS), **STATICS), tx)
    _, opt_state, metrics = j_step(params, tx.init(params), None, jnp.asarray(AABB),
                                   jnp.asarray(rays), jnp.asarray(rgbs), jnp.asarray(3), key)
    total, _ = loss_fn(field, TStatics(weights=TWeights(**WEIGHTS), **STATICS), t(AABB), t(rays),
                       t(rgbs), 3, *noise(key, 64))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(metrics["total_loss"]), rtol=1e-5,
                               atol=1e-6)
    j_grads = _flat(opt_state["g"])
    for name, p in field.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name], err_msg=name, **GRAD)


def test_ndc_loss_trajectory_follows_jax(rng):
    """15 NDC steps from the same params, batches and noise: the same loss
    curve (1e-3 relative per step)."""
    params, field = jax_and_port(5)
    tx, state = j_make_optimizer(params, 0.02, 1e-3, 0.999)
    j_step = j_make_train_step(JM, CFG, JStatics(weights=JWeights(**WEIGHTS), **STATICS), tx)
    opt = make_optimizer(field, 0.02, 1e-3, 0.999)
    statics = TStatics(weights=TWeights(**WEIGHTS), **STATICS)
    losses = []
    for it in range(15):
        rays = ndc_rays(rng, 64)
        rgbs = rng.uniform(size=(64, 3)).astype(np.float32)
        key = jax.random.PRNGKey(200 + it)
        params, state, metrics = j_step(params, state, None, jnp.asarray(AABB),
                                        jnp.asarray(rays), jnp.asarray(rgbs), jnp.asarray(it),
                                        key)
        opt.zero_grad()
        total, _ = loss_fn(field, statics, t(AABB), t(rays), t(rgbs), it, *noise(key, 64))
        total.backward()
        opt.step()
        losses.append(float(total.detach()))
        np.testing.assert_allclose(losses[-1], float(metrics["total_loss"]), rtol=1e-3,
                                   err_msg=f"step {it}")
    assert losses[-1] < losses[0]


# ---- the whole slice: configs/flower.txt through both CLIs --------------------------

# configs/flower.txt cut to a tiny run: the four upsamples and the alpha
# mask within 12 steps, small widths, a 10-view 40x30 capture
FLOWER_TINY = dict(n_iters=12, N_voxel_init=10**3, N_voxel_final=20**3,
                   upsamp_list=[3, 5, 7, 9], update_AlphaMask_list=[6], batch_size=256,
                   n_lamb_sigma=[3, 2, 2], n_lamb_sh=[4, 3, 3], data_dim_color=6, featureC=16,
                   vis_every=100, progress_refresh_rate=5, seed=3, render_path=0)
FLOWER_VIEWS = dict(n_views=10, wh=(40, 30))


def _flags(over):
    return [a for k, v in over.items()
            for a in (f"--{k}", str(v).replace(" ", "") if isinstance(v, list) else str(v))]


def _psnr(out):
    return float(re.findall(r"test all psnr: ([0-9.eE+-]+)", out)[-1])


def test_flower_txt_runs_through_both_clis(tmp_path, capsys):
    """configs/flower.txt trains through both CLIs on one on-disk capture;
    their noise streams differ, so the two final PSNRs agree within 1.5 dB.
    Each package's final checkpoint crosses to the other and renders the
    same test PSNR there (1e-4 dB; JAX op by op)."""
    datadir = str(tmp_path / "scene")
    write_forward_facing_scene(datadir, make_forward_facing_scene(**FLOWER_VIEWS))
    flags = [*_flags(FLOWER_TINY), "--datadir", datadir]
    capsys.readouterr()
    train_cli.main(["--config", "configs/flower.txt", *flags, "--basedir", str(tmp_path / "jax")])
    jax_psnr = _psnr(capsys.readouterr().out)
    (jax_ckpt,) = (tmp_path / "jax").glob("*/tensorf_flower_VM/final_tensorf_flower_VM.npz")
    port_only = ["--device", "cpu", "--save_images", "0"]
    assert cli.main(["--config", "configs/flower.txt", *flags, *port_only,
                     "--basedir", str(tmp_path / "port")]) == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(trained["segments"]) == 6 and not any(s["strata"] for s in trained["segments"])
    assert abs(trained["final_test_psnr"] - jax_psnr) <= 1.5, (trained["final_test_psnr"], jax_psnr)

    def render_only(ckpt):
        return ["--config", "configs/flower.txt", *flags, "--render_only", "1",
                "--render_test", "1", "--ckpt", str(ckpt)]

    for ckpt, psnr in ((trained["final_ckpt"], trained["final_test_psnr"]), (jax_ckpt, jax_psnr)):
        assert cli.main(render_only(ckpt) + port_only) == 0
        port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["test_psnr"]
        with jax.disable_jit():
            train_cli.main(render_only(ckpt))
        assert abs(port - psnr) <= 1e-4 and abs(_psnr(capsys.readouterr().out) - psnr) <= 1e-4
    cfg, field, *_ = tckpt.load_checkpoint(trained["final_ckpt"], device="cpu")
    assert tuple(jckpt.load_checkpoint(trained["final_ckpt"])[3]) == field.grid_size
