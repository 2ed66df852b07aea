"""Parity of the port's stratified serving with tensorf_tpu's.

The same seeded numpy inputs go through both packages at the sizes of
tests/test_window_bits.py (grid 12^3, 128 samples, a 35%-occupied 10^3
mask): the window-bits pack and unpack and the serving count pass (exact),
render_rays' window-bits path and its preconditions, the chunk and tier
ladders, both serving paths and the legacy path's exact-alive stage (rgb
1e-5, depth 1e-4, overflow 0.0, against JAX's serving and the port's
unbudgeted uniform render), the tiled render_frame, rays_from_pose,
the eval handle's render, the stratified evaluation and trajectory
rendering, and a
tiny schedule that serves stratified, renders its train split and
re-renders its final PSNR through the render-only CLI.

The JAX serving functions are jitted, and compiled XLA rounds some fused
expressions differently, which moves a sample across the bbox boundary now
and then; the comparisons that hold the port to 1e-5 therefore run JAX op
by op (``jax.disable_jit``), the arithmetic as written.
"""

import dataclasses
import importlib
import json

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models import alpha_mask as jam
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.render import chunked as jch
from tensorf_tpu.render import culling as jcull
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.utils import ckpt as jckpt
from tensorf_tpu_torch import __main__ as cli
from tensorf_tpu_torch.config import load_config
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.data.blender import BlenderDataset
from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import TensorVMSplit
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.models.config import GridGeometry
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.ops.rays import get_rays, sample_along_rays, sample_lattice
from tensorf_tpu_torch.render import chunked as tch
from tensorf_tpu_torch.render import culling as tcull
from tensorf_tpu_torch.render import volume as tvolume
from tensorf_tpu_torch.train import loop as tloop

CFG = ModelConfig(
    model_name="TensorVMSplit", density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6), app_dim=9,
    shading_mode="MLP_Fea", pos_pe=2, view_pe=2, fea_pe=2, feature_c=32, density_shift=-3.0,
)
GRID = (12, 12, 12)
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
STEP = 0.05
NS = 128
NEAR_FAR = (2.0, 6.0)
JM = FIELD_MODELS["TensorVMSplit"]
# the modules (the packages' __init__ export the function of that name)
jeval = importlib.import_module("tensorf_tpu.eval.evaluation")
teval = importlib.import_module("tensorf_tpu_torch.eval.evaluation")
RGB = dict(rtol=1e-5, atol=1e-5)
DEPTH = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def _rays(rng, n, miss=0):
    """n rays from radius 4 toward the center (with direction noise), the
    last ``miss`` of them turned away from the box."""
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rays[n - miss :, 3:6] *= -1.0
    return rays


@pytest.fixture(scope="module")
def setup():
    params = JM.init(jax.random.PRNGKey(0), CFG, GRID)
    flat = {}
    jckpt._flatten("", params, flat)
    field = TensorVMSplit(TConfig(**dataclasses.asdict(CFG)), GRID, device="cpu")
    field.load_state_dict(params_from_jax(flat))
    vol = (np.random.default_rng(7).uniform(size=(10, 10, 10)) < 0.35).astype(np.float32)
    jmask = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(AABB), volume=jnp.asarray(vol)))
    pmask = tam.with_dilation(tam.AlphaGridMask(aabb=t(AABB), volume=t(vol)))
    return params, field, jmask, pmask


def _serve_kw(chunk=64, n_samples=NS):
    return dict(step_size=STEP, n_samples=n_samples, white_bg=True, ndc_ray=False, chunk=chunk)


def _uniform(field, pmask, rays, n_samples=NS, shade_top_k=None):
    """The port's unbudgeted masked render, numpy."""
    rgb, depth, _, _ = tch.render_chunked(field, pmask, rays, t(AABB), chunk=64, step_size=STEP,
                                          n_samples=n_samples, white_bg=True,
                                          shade_top_k=shade_top_k)
    return rgb.numpy(), depth.numpy()


# ---- the window bits and the count pass ------------------------------------------


@pytest.mark.parametrize("G", [1, 7, 8, 9, 32, 33, 262])
def test_window_bits_pack_and_unpack_match_jnp(rng, G):
    bits = rng.uniform(size=(5, G)) < 0.4
    packed = tvolume.pack_window_bits(t(bits))
    want = np.asarray(jnp.packbits(jnp.asarray(bits), axis=-1, bitorder="little"))
    assert packed.dtype == torch.uint8 and packed.shape == (5, -(-G // 8))
    np.testing.assert_array_equal(packed.numpy(), want)
    unpacked = tvolume.unpack_window_bits(packed)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(jnp.unpackbits(jnp.asarray(want), axis=-1, bitorder="little") > 0))
    np.testing.assert_array_equal(unpacked.numpy()[:, :G], bits)
    assert not unpacked.numpy()[:, G:].any()


@pytest.mark.parametrize("tile", [64, 1000])
def test_count_bits_match_jax(setup, rng, tile):
    """Counts, chords, bits and the padded ray store equal JAX's run op by
    op; numpy rays (tail tile padded) and a tensor alike; misses count 0."""
    _, _, jmask, pmask = setup
    rays = _rays(rng, 240, miss=30)
    got = tcull.count_ray_candidates_chord_bits(rays if tile == 64 else t(rays), pmask, AABB, STEP,
                                                NEAR_FAR, n_samples=NS, tile=tile)
    with jax.disable_jit():
        want = jcull.count_ray_candidates_chord_bits(rays, jmask, AABB, STEP, NEAR_FAR,
                                                     n_samples=NS, tile=tile)
    counts, chords, bits, store = got
    assert counts.dtype == chords.dtype == np.int32 and bits.dtype == torch.uint8
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(chords, want[1])
    assert bits.shape == (-(-240 // tile) * tile, 4) == np.asarray(want[2]).shape
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(store.numpy(), np.asarray(want[3]))
    assert (counts[-30:] == 0).all() and (chords[-30:] == 0).all() and counts.max() > 0
    # the same counts and chords as the training side's probe-only pass
    for a, b in zip((counts, chords), tcull.count_ray_candidates_and_chord(
            rays, pmask, AABB, STEP, NEAR_FAR, n_samples=NS), strict=True):
        np.testing.assert_array_equal(a, b)


def test_count_bits_superset_of_render_windows(setup, rng):
    """The unpacked bits within the chord cover every window the in-render
    coarse gate selects, the padded count covers the bits' own windows (the
    tier never overflows) and a zero count has no selected window."""
    _, _, _, pmask = setup
    rays = _rays(rng, 240)
    counts, chords, bits, _ = tcull.count_ray_candidates_chord_bits(
        rays, pmask, AABB, STEP, NEAR_FAR, n_samples=NS, tile=64)
    M, S, G = rays.shape[0], tam.COARSE_STRIDE, -(-NS // tam.COARSE_STRIDE)
    ghits = tvolume.unpack_window_bits(bits[:M]).numpy()
    starts = np.arange(ghits.shape[1]) * S
    gkeep_bits = ghits & (starts[None, :] < chords[:, None]) & (starts[None, :] < NS)
    xyz, _, valid = sample_along_rays(t(rays[:, :3]), t(rays[:, 3:6]), t(AABB), *NEAR_FAR, STEP,
                                      NS, None)
    cand = (valid & tam.sample_alpha_gate_coarse(pmask, xyz)).numpy()
    gkeep_render = np.pad(cand, ((0, 0), (0, G * S - NS))).reshape(M, G, S).any(axis=-1)
    assert not (gkeep_render & ~gkeep_bits[:, :G]).any()
    assert (S * gkeep_bits.sum(axis=-1) <= counts).all()
    assert not gkeep_render[counts == 0].any()


# ---- render_rays' window-bits path --------------------------------------------------


def _lattice_index(z, rays):
    t_min = sample_lattice(t(rays[:, :3]), t(rays[:, 3:6]), t(AABB), *NEAR_FAR).numpy()
    return np.rint((np.asarray(z) - t_min[:, None]) / STEP).astype(np.int64)


@pytest.mark.parametrize("budget", [32, 64, 128])
def test_window_bits_render_matches_jax(setup, rng, budget):
    """At key=None, field for field and index for index; a budget that
    covers every count renders what the unbudgeted masked render does."""
    params, field, jmask, pmask = setup
    rays = _rays(rng, 64, miss=4)
    counts, _, bits, _ = tcull.count_ray_candidates_chord_bits(
        rays, pmask, AABB, STEP, NEAR_FAR, n_samples=NS, tile=64)
    kw = dict(step_size=STEP, n_samples=NS, is_train=False, white_bg=True, ndc_ray=False,
              shade_top_k=16, fused=True, sample_budget=budget, budget_mode="cand")
    want = j_render(JM, CFG, params, jmask, jnp.asarray(rays), None, JMasks(),
                    aabb=jnp.asarray(AABB), cand_window_bits=jnp.asarray(bits.numpy()), **kw)
    with torch.no_grad():
        got = tvolume.render_rays(field, t(rays), TMasks(), aabb=t(AABB), alpha_mask=pmask,
                                  cand_window_bits=bits, **kw)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), **RGB)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), **DEPTH)
    for name in ("weights", "sigma", "z_vals"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **RGB)
    assert float(got.budget_overflow_frac) == float(want.budget_overflow_frac)
    assert float(got.mean_alive_samples) == float(want.mean_alive_samples)
    assert int(got.num_valid_samples) == int(want.num_valid_samples)
    assert got.z_vals.shape == (64, budget)
    np.testing.assert_array_equal(_lattice_index(got.z_vals, rays), _lattice_index(want.z_vals, rays))
    if budget >= counts.max():
        assert float(got.budget_overflow_frac) == 0.0
        rgb, depth = _uniform(field, pmask, rays, shade_top_k=16)
        np.testing.assert_allclose(got.rgb.numpy(), rgb, **RGB)
        np.testing.assert_allclose(got.depth.numpy(), depth, **DEPTH)
    else:
        assert float(got.budget_overflow_frac) > 0.0


BAD_WINDOW_BITS = {
    "no_mask": dict(alpha_mask=None),
    "no_budget": dict(sample_budget=None),
    "budget_over_lattice": dict(sample_budget=132),
    "budget_not_stride_multiple": dict(sample_budget=50),
    "alive_mode": dict(budget_mode="alive"),
    "ndc": dict(ndc_ray=True),
}


@pytest.mark.parametrize("case", list(BAD_WINDOW_BITS))
def test_window_bits_preconditions_raise_as_in_jax(setup, case):
    params, field, jmask, pmask = setup
    rays = _rays(np.random.default_rng(1), 8)
    bits = np.zeros((8, 4), np.uint8)
    kw = dict(step_size=STEP, n_samples=NS, is_train=False, white_bg=True, ndc_ray=False,
              sample_budget=64, budget_mode="cand")
    bad = dict(BAD_WINDOW_BITS[case])
    masked = bad.pop("alpha_mask", True) is not None
    kw.update(bad)
    with pytest.raises(ValueError, match="cand_window_bits"):
        j_render(JM, CFG, params, jmask if masked else None, jnp.asarray(rays), None, JMasks(),
                 aabb=jnp.asarray(AABB), cand_window_bits=jnp.asarray(bits), **kw)
    with pytest.raises(ValueError, match="cand_window_bits"):
        tvolume.render_rays(field, t(rays), TMasks(), aabb=t(AABB),
                            alpha_mask=pmask if masked else None, cand_window_bits=t(bits), **kw)


# ---- the serving paths -------------------------------------------------------------


def test_chunk_and_tier_ladders_match_jax():
    assert tch.BUDGET_TIERS == jch.BUDGET_TIERS and tch._CHUNK_LADDER == jch._CHUNK_LADDER
    for cap in (64, 1024, 2048, 4096, 8192, 32768, 65536):
        for rem in [*range(1, 3000, 7), *range(3000, 70000, 997)]:
            assert tch._next_chunk(rem, cap) == jch._next_chunk(rem, cap), (rem, cap)


SERVING_PATHS = {
    "resident": dict(),
    "resident_top_k": dict(shade_top_k=16),
    "legacy_exact_gate": dict(use_coarse_gate=False),
    "legacy_alive_stage": dict(alive_stage=True),
}


@pytest.mark.parametrize("path", list(SERVING_PATHS))
def test_stratified_paths_match_jax_and_uniform(setup, rng, path):
    """Resident (with and without top-K shading) and legacy paths against
    JAX's and the port's unbudgeted uniform render, with zero-candidate
    rays composited on the host; the resident path shades the same sample
    count as JAX's."""
    params, field, jmask, pmask = setup
    rays = _rays(rng, 230, miss=30)
    logs = []
    rgb, depth, n_valid, overflow = tch.render_chunked_stratified(
        field, pmask, rays, t(AABB), log=logs.append, **_serve_kw(), **SERVING_PATHS[path])
    with jax.disable_jit():
        want = jch.render_chunked_stratified(JM, CFG, params, jmask, rays, jnp.asarray(AABB),
                                              **_serve_kw(), **SERVING_PATHS[path])
    assert overflow == want[3] == 0.0
    np.testing.assert_allclose(rgb, want[0], **RGB)
    np.testing.assert_allclose(depth, want[1], **DEPTH)
    if path.startswith("resident"):
        assert n_valid == want[2]
    u_rgb, u_depth = _uniform(field, pmask, rays, shade_top_k=SERVING_PATHS[path].get("shade_top_k"))
    np.testing.assert_allclose(rgb, u_rgb, **RGB)
    np.testing.assert_allclose(depth, u_depth, **DEPTH)
    zero = int(logs[0].split(", ")[1].split()[0])
    assert logs[0].startswith("count pass: 230 rays") and zero >= 30
    assert sum(int(line.split("rays=")[1].split()[0]) for line in logs[1:]) == 230 - zero


def test_alive_stage_compacts_to_the_alive_tier(setup, rng):
    """The legacy path's exact-alive second stage engages (a bucket's alive
    tier undercuts its candidate tier) and still renders the unbudgeted
    image.  The mask is a ball of radius 0.5: its dilated shell puts
    candidates well above alive samples."""
    _, field, _, _ = setup
    g = (np.arange(10) + 0.5) * 0.3 - 1.5
    ball = np.linalg.norm(np.stack(np.meshgrid(g, g, g, indexing="ij")), axis=0) < 0.5
    pmask = tam.with_dilation(tam.AlphaGridMask(aabb=t(AABB), volume=t(ball.astype(np.float32))))
    rays = _rays(rng, 230, miss=30)
    logs = []
    rgb, depth, _, overflow = tch.render_chunked_stratified(
        field, pmask, rays, t(AABB), alive_stage=True, log=logs.append, **_serve_kw())
    alive = [line.split("alive=")[1].split()[0] for line in logs[1:]]
    assert overflow == 0.0 and any(a != "None" for a in alive)
    u_rgb, u_depth = _uniform(field, pmask, rays)
    np.testing.assert_allclose(rgb, u_rgb, **RGB)
    np.testing.assert_allclose(depth, u_depth, **DEPTH)


def test_stratified_chord_cap_exact(setup, rng):
    """A lattice far longer than any chord: the buckets render on capped
    lattices (128 of 256) and still equal the full-lattice uniform render
    and JAX's."""
    params, field, jmask, pmask = setup
    rays = _rays(rng, 150)
    logs = []
    rgb, depth, _, overflow = tch.render_chunked_stratified(
        field, pmask, rays, t(AABB), log=logs.append, **_serve_kw(n_samples=256))
    assert overflow == 0.0 and all("lattice=128" in line for line in logs[1:])
    u_rgb, u_depth = _uniform(field, pmask, rays, n_samples=256)
    np.testing.assert_allclose(rgb, u_rgb, **RGB)
    np.testing.assert_allclose(depth, u_depth, **DEPTH)
    with jax.disable_jit():
        want = jch.render_chunked_stratified(JM, CFG, params, jmask, rays, jnp.asarray(AABB),
                                              **_serve_kw(n_samples=256))
    np.testing.assert_allclose(rgb, want[0], **RGB)
    np.testing.assert_allclose(depth, want[1], **DEPTH)


def test_device_rays_render_as_host_rays(setup, rng):
    """Rays given as a tensor (the rays_from_pose path) render exactly as
    the same rays given as a numpy array."""
    _, field, _, pmask = setup
    rays = _rays(rng, 200, miss=20)
    host = tch.render_chunked_stratified(field, pmask, rays, t(AABB), **_serve_kw())
    dev = tch.render_chunked_stratified(field, pmask, t(rays), t(AABB), **_serve_kw())
    for a, b in zip(host, dev, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile", [64, 1000])
def test_render_frame_matches_render_chunked_and_jax(setup, rng, tile):
    """Fixed tiles, the last padded by the last ray: the uniform chunked
    render's pixels and JAX's render_frame's."""
    params, field, jmask, pmask = setup
    rays = _rays(rng, 150, miss=10)
    kw = dict(step_size=STEP, n_samples=NS, white_bg=True, shade_top_k=16)
    rgb, depth = tch.render_frame(field, pmask, rays, t(AABB), tile=tile, **kw)
    assert rgb.shape == (150, 3) and depth.shape == (150,)
    u_rgb, u_depth = _uniform(field, pmask, rays, shade_top_k=16)
    np.testing.assert_allclose(rgb, u_rgb, **RGB)
    np.testing.assert_allclose(depth, u_depth, **DEPTH)
    with jax.disable_jit():
        want = jch.render_frame(dict(model=JM, cfg=CFG, ndc_ray=False, **kw), params, jmask, rays,
                                jnp.asarray(AABB), tile=tile)
    np.testing.assert_allclose(rgb, want[0], **RGB)
    np.testing.assert_allclose(depth, want[1], **DEPTH)


def test_rays_from_pose_matches_get_rays(rng):
    from tensorf_tpu.ops.rays import get_rays as j_get_rays

    directions = rng.normal(size=(8, 8, 3)).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    c2w[:3, 3] = [0.3, -0.2, 4.0]
    rays = tch.rays_from_pose(t(directions.reshape(-1, 3)), t(c2w)).numpy()
    assert rays.shape == (64, 6) and rays.dtype == np.float32
    for o, d in (get_rays(directions, c2w), j_get_rays(directions, c2w)):
        np.testing.assert_allclose(rays[:, :3], o, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rays[:, 3:], np.asarray(d), rtol=1e-6, atol=1e-6)


# ---- evaluation ----------------------------------------------------------------------


def _views(wh=16, n_test=2):
    scene = make_synthetic_scene_arrays(n_train=1, n_test=n_test, wh=(wh, wh), scene="sphere")
    return BlenderDataset("", split="test", wh=(wh, wh), is_stack=True, meta=scene["test"])


def _handles(setup, **kw):
    params, field, jmask, pmask = setup
    common = dict(step_size=STEP, n_samples=NS, white_bg=True, shade_top_k=16, **kw)
    port = teval.RendererHandle(field=field, alpha_mask=pmask, aabb=t(AABB), **common)
    jax_ = jeval.RendererHandle(model=JM, cfg=CFG, params=params, alpha_mask=jmask,
                                aabb=jnp.asarray(AABB), ndc_ray=False, **common)
    return port, jax_


@pytest.mark.parametrize("coarse", [True, False], ids=["resident", "legacy"])
def test_handle_render_serves_stratified(setup, rng, coarse):
    """A stratified handle renders what render_chunked_stratified does,
    hands it the log, and records the overflow (none)."""
    _, field, _, pmask = setup
    rays = _rays(rng, 120, miss=10)
    port, _ = _handles(setup, stratified=True, use_coarse_gate=coarse)
    logs, want_logs = [], []
    got = port.render(t(rays), chunk=64, log=logs.append)
    want = tch.render_chunked_stratified(field, pmask, rays, t(AABB), shade_top_k=16,
                                         use_coarse_gate=coarse, log=want_logs.append,
                                         **_serve_kw())
    for a, b in zip(got, want[:3], strict=True):
        np.testing.assert_array_equal(a, b)
    assert logs == want_logs and logs[0].startswith("count pass: 120 rays")
    assert port.max_overflow == want[3] == 0.0


def test_stratified_evaluation_gives_jax_psnrs(setup, capsys):
    """A stratified handle's PSNRs equal JAX's stratified evaluation's and
    record no overflow; a uniform handle at a budget its rays overflow
    warns and records it."""
    ds = _views()
    port, jax_ = _handles(setup, stratified=True, sample_budget=32)
    got = teval.evaluation(ds, port)
    with jax.disable_jit():
        want = jeval.evaluation(ds, jax_, compute_extra_metrics=False)
    assert len(got) == 2 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert port.max_overflow == 0.0 and "WARNING" not in capsys.readouterr().out
    uniform, _ = _handles(setup, sample_budget=8)
    teval.evaluation(ds, uniform)
    assert uniform.max_overflow > 0.0 and "sample-budget overflow" in capsys.readouterr().out


def test_evaluation_path_writes_jax_frames(setup, tmp_path):
    ds = _views()
    port, jax_ = _handles(setup, stratified=True)
    assert teval.evaluation_path(ds, port, ds.poses, str(tmp_path / "port")) == []
    jeval.evaluation_path(ds, jax_, ds.poses, str(tmp_path / "jax"))
    for idx in range(len(ds.poses)):
        got = imageio.imread(tmp_path / "port" / "prediction" / f"{idx:03d}.png").astype(int)
        want = imageio.imread(tmp_path / "jax" / "prediction" / f"{idx:03d}.png").astype(int)
        assert got.shape == want.shape == (16, 16, 3)
        assert np.abs(got - want).max() <= 1
    assert list((tmp_path / "port").glob("video.*")) and list((tmp_path / "port").glob("depthvideo.*"))


def test_tiny_stratified_serving_reconstruction(tmp_path, capsys):
    """synth_sphere's schedule cut to 10 steps with stratify, stratify_render
    and render_train on: every evaluation serves stratified with no
    overflow, the train split renders into imgs_train_all/, the final test
    PSNR equals JAX's stratified evaluation of the final checkpoint (its
    render-only handle, tensorf_tpu loop.py:1440-1464), and the render-only
    CLI reproduces it."""
    over = dict(n_iters=10, N_voxel_init=10**3, N_voxel_final=16**3, upsamp_list=[3, 6],
                update_AlphaMask_list=[4, 7], batch_size=256, downsample_train=1, vis_every=5,
                save_ckpt_every=[], progress_refresh_rate=5, seed=3, sample_budget=64,
                prefilter_budget=96, render_train=1, basedir=str(tmp_path))
    cfg = load_config("configs/synth_sphere.txt", over)
    assert cfg.stratify == cfg.stratify_render == cfg.render_test == 1
    scene = make_synthetic_scene_arrays(n_train=4, n_test=1, wh=(40, 40), scene="sphere")
    logs = []
    res = tloop.reconstruction(cfg, scene, "cpu", save_images=True, log=logs.append)
    assert res.eval_overflow == {5: 0.0, 10: 0.0}
    assert tloop.make_handle(res.state).stratified
    (folder,) = tmp_path.glob("*/synth_sphere")
    assert sorted(p.name for p in (folder / "imgs_train_all" / "prediction").iterdir()) == [
        f"{i:03d}.png" for i in range(4)]
    assert (folder / "imgs_test_all" / "prediction" / "000.png").exists()
    assert any("train all psnr" in line for line in logs)

    mcfg, jparams, aabb, grid, jmask, _ = jckpt.load_checkpoint(res.final_path)
    geometry = GridGeometry.create(aabb, grid, mcfg.step_ratio)
    handle = jeval.RendererHandle(
        model=FIELD_MODELS[mcfg.model_name], cfg=mcfg, params=jparams, alpha_mask=jmask,
        aabb=jnp.asarray(geometry.aabb_np), step_size=geometry.step_size,
        n_samples=min(int(cfg.nSamples), geometry.n_samples), white_bg=True, ndc_ray=False,
        shade_top_k=cfg.shade_top_k if cfg.shade_top_k > 0 else None, fused=True,
        use_coarse_gate=jam.coarse_gate_valid(jmask, geometry.step_size, False),
        stratified=True, sample_budget=cfg.sample_budget)
    with jax.disable_jit():
        want = jeval.evaluation(res.state.test_ds, handle, compute_extra_metrics=False)
    np.testing.assert_allclose(res.final_psnrs, want, rtol=0, atol=1e-4)

    capsys.readouterr()
    argv = ["--config", "configs/synth_sphere.txt", "--render_only", "1", "--render_test", "1",
            "--downsample_train", "1", "--device", "cpu", "--synthetic", "--synthetic_scene",
            "sphere", "--synthetic_views", "4,1", "--synthetic_wh", "40", "--save_images", "0",
            "--sample_budget", "64", "--ckpt", res.final_path]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["test_psnr"] - float(np.mean(res.final_psnrs))) <= 1e-4
