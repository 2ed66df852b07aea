"""Parity of the port's coarse-to-fine schedule with tensorf_tpu's.

The same seeded numpy inputs go through both packages: the align-corners
resize, upsample and shrink, the alpha mask (trilinear and nearest
lookups, its dilation, its rebuild from the field), the alpha ray filter,
the masked render, and each schedule event of the training loop against
the JAX loop's own event code (tensorf_tpu/train/loop.py:1196-1338).
Tolerance rtol/atol 1e-5 (float32) unless a test says otherwise; lookups,
bits, grids and kept ray sets must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorf_tpu.config.frontends import load_config as j_load_config
from tensorf_tpu.config.schema import model_config_from as j_model_config_from
from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models import alpha_mask as jam
from tensorf_tpu.models.config import GridGeometry as JGeometry
from tensorf_tpu.models.config import cal_n_samples as j_cal_n_samples
from tensorf_tpu.models.config import n_to_reso as j_n_to_reso
from tensorf_tpu.models.config import n_voxel_schedule as j_n_voxel_schedule
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.ops.freq_mask import free_masks as j_free_masks
from tensorf_tpu.ops.grid_sample import grid_sample_3d as j_grid_sample_3d
from tensorf_tpu.ops.resize import resize_bilinear_align_corners as j_resize2
from tensorf_tpu.ops.resize import resize_linear_align_corners as j_resize1
from tensorf_tpu.render import culling as jcull
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch.config import load_config as t_load_config
from tensorf_tpu_torch.convert import params_from_jax, params_to_jax
from tensorf_tpu_torch.data.base import resize_lanczos
from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import TensorVMSplit
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.models.config import n_voxel_schedule
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.ops.grid_sample import grid_sample_3d
from tensorf_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_linear_align_corners
from tensorf_tpu_torch.render import culling as tcull
from tensorf_tpu_torch.render import render_rays as t_render
from tensorf_tpu_torch.train import loop as tloop

FWD = dict(rtol=1e-5, atol=1e-5)
JM = FIELD_MODELS["TensorVMSplit"]
# one compiled program instead of one per eager op (CPU-fast tests); the
# renders stay eager: XLA's fused render moves gate and top-K boundary
# samples by float32 rounding, the op-by-op one is the port's reference
j_upsample = jax.jit(JM.upsample, static_argnums=(0, 2))
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
# density_shift -10 keeps empty space below the mask threshold
CFG = ModelConfig(
    model_name="TensorVMSplit", density_n_comp=(2, 3, 4), app_n_comp=(4, 3, 2), app_dim=6,
    shading_mode="MLP_Fea", pos_pe=2, view_pe=2, fea_pe=2, feature_c=16, density_shift=-10.0,
)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=FWD):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def _flat(params):
    out = {}
    _flatten("", params, out)
    return out


def blob_params(seed, grid, cfg=CFG, center=(0.3, -0.2, 0.1), width=0.35):
    """JAX params whose density is a Gaussian blob off the bbox centre: a
    mask with a tight bbox well inside the scene's."""
    params = JM.init(jax.random.PRNGKey(seed), cfg, grid)
    axes = [np.linspace(-1.5, 1.5, g) for g in grid]  # x, y, z

    def bump(axis):
        return np.exp(-((axes[axis] - center[axis]) ** 2) / (2 * width**2))

    planes, lines = [], []
    for i, ((m0, m1), v) in enumerate(zip(((0, 1), (0, 2), (1, 2)), (2, 1, 0))):
        r = cfg.density_n_comp[i]
        plane = 3.0 * bump(m1)[:, None] * bump(m0)[None, :]
        planes.append(jnp.asarray(np.repeat(plane[..., None], r, -1), jnp.float32))
        lines.append(jnp.asarray(np.repeat(bump(v)[:, None], r, -1), jnp.float32))
    return {**params, "density_plane": tuple(planes), "density_line": tuple(lines)}


def port_field(params, cfg=CFG):
    grid = JM.grid_size_of(params)
    field = TensorVMSplit(TConfig(**dataclasses.asdict(cfg)), grid, device="cpu")
    field.load_state_dict(params_from_jax(_flat(params)))
    return field


def both_masks(volume, aabb):
    j = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(aabb), volume=jnp.asarray(volume)))
    p = tam.with_dilation(tam.AlphaGridMask(aabb=t(aabb), volume=t(volume)))
    return j, p


def random_mask(rng, shape=(8, 9, 10), aabb=((-1.2, -1.3, -1.1), (1.3, 1.2, 1.25))):
    vol = (rng.uniform(size=shape) < 0.15).astype(np.float32)
    return both_masks(vol, np.asarray(aabb, np.float32))


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return np.concatenate([o, d], -1).astype(np.float32)


# ---- resize, upsample, shrink ------------------------------------------------


@pytest.mark.parametrize("shape,target", [((5, 7, 3), (9, 13)), ((6, 4, 2), (6, 11)), ((1, 3, 2), (4, 5))])
def test_resize_matches_jax_and_f_interpolate(rng, shape, target):
    plane = rng.normal(size=shape).astype(np.float32)
    got = resize_bilinear_align_corners(t(plane), *target)
    close(got, j_resize2(jnp.asarray(plane), *target))
    ref = F.interpolate(t(plane).permute(2, 0, 1)[None], size=target, mode="bilinear",
                        align_corners=True)[0].permute(1, 2, 0)
    close(got, ref)
    line = plane[:, 0, :]
    got = resize_linear_align_corners(t(line), target[1])
    close(got, j_resize1(jnp.asarray(line), target[1]))
    ref = F.interpolate(t(line).T[None], size=target[1], mode="linear", align_corners=True)[0].T
    close(got, ref)


def test_upsample_and_shrink_match_jax():
    params = JM.init(jax.random.PRNGKey(0), CFG, (7, 8, 9))
    field = port_field(params)
    new_grid = (11, 10, 13)
    field.upsample(new_grid)
    want = _flat(j_upsample(CFG, params, new_grid))
    assert field.grid_size == new_grid
    for k, v in params_to_jax(field).items():
        close(v, want[k])
    t_l, b_r = (2, 1, 3), (9, 10, 12)
    field.shrink(t_l, b_r)
    want = _flat(JM.shrink(CFG, j_upsample(CFG, params, new_grid), t_l, b_r))
    assert field.grid_size == (7, 9, 9)
    for k, v in params_to_jax(field).items():
        close(v, want[k])
    assert all(p.requires_grad and p.is_leaf for p in field.parameters())


def test_n_voxel_schedule_matches_jax():
    for args in ((2097156, 27000000, 5), (13824, 64000, 1), (1000, 8000, 3)):
        assert n_voxel_schedule(*args) == j_n_voxel_schedule(*args)


def test_lanczos_downsample_equals_pil(rng):
    """The in-memory scene's downsample equals PIL's LANCZOS exactly."""
    from PIL import Image

    img = make_synthetic_scene_arrays(n_train=1, n_test=0, wh=(96, 96))["train"]["frames"][0]["image"]
    for src, wh in ((img, (12, 12)), (img, (40, 30)),
                    (rng.integers(0, 256, (20, 17, 4)).astype(np.uint8), (35, 9)),
                    (rng.integers(0, 256, (21, 13, 3)).astype(np.uint8), (7, 5))):
        want = np.asarray(Image.fromarray(src).resize(wh, Image.LANCZOS))
        np.testing.assert_array_equal(resize_lanczos(src, wh), want)


# ---- the alpha mask ----------------------------------------------------------


def test_grid_sample_3d_matches_jax_and_f_grid_sample(rng):
    vol = rng.normal(size=(5, 6, 7)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, size=(300, 3)).astype(np.float32)
    got = grid_sample_3d(t(vol), t(coords))
    close(got, j_grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords)))
    ref = F.grid_sample(t(vol)[None, None], t(coords)[None, None, None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    close(got, ref.reshape(-1))


def test_max_pool_and_mask_lookups_match_jax(rng):
    vol = rng.normal(size=(6, 7, 8)).astype(np.float32) - 2.0  # negative: padding must not win
    close(tam.max_pool_3d_same(t(vol), 3), jam.max_pool_3d_same(jnp.asarray(vol), 3), dict(rtol=0, atol=0))
    jmask, pmask = random_mask(rng)
    np.testing.assert_array_equal(pmask.dilated.numpy(), np.asarray(jmask.dilated))
    assert pmask.grid_size == tuple(jmask.grid_size)
    xyz = rng.uniform(-1.5, 1.5, size=(500, 3)).astype(np.float32)
    # points on half-voxel boundaries: round half to even on both sides
    vox = (pmask.aabb[1] - pmask.aabb[0]).numpy() / (np.asarray(pmask.grid_size) - 1)
    half = pmask.aabb[0].numpy() + vox * (np.arange(6)[:, None] + 0.5)
    xyz = np.concatenate([xyz, half.astype(np.float32)])
    close(tam.sample_alpha(pmask, t(xyz)), jam.sample_alpha(jmask, jnp.asarray(xyz)))
    np.testing.assert_array_equal(
        tam.sample_alpha_gate(pmask, t(xyz)).numpy(),
        np.asarray(jam.sample_alpha_gate(jmask, jnp.asarray(xyz))),
    )
    for step in (0.01, 0.07, 0.2):
        for ndc in (False, True):
            assert tam.coarse_gate_valid(pmask, step, ndc) == jam.coarse_gate_valid(jmask, step, ndc)
    assert tam.coarse_gate_valid(None, 1.0, True) is True


@pytest.mark.parametrize("with_prior_mask", [False, True], ids=["first", "masked"])
def test_update_alpha_mask_matches_jax(rng, with_prior_mask):
    grid = (14, 16, 15)
    params = blob_params(1, grid)
    field = port_field(params)
    step = JGeometry.create(AABB, grid, 0.5).step_size
    den = tuple(rng.uniform(0.5, 1.0, size=(r,)).astype(np.float32) for r in CFG.density_n_comp)
    jprior = pprior = None
    if with_prior_mask:
        jprior, pprior = random_mask(rng, (9, 8, 7), AABB)
    alpha_t, xyz_t = tcull.compute_alpha_grid(field, pprior, AABB, grid, step, tuple(t(d) for d in den))
    alpha_j, xyz_j = jcull.compute_alpha_grid(JM, CFG, params, jprior, AABB, grid, step,
                                              tuple(jnp.asarray(d) for d in den))
    close(alpha_t, alpha_j)
    np.testing.assert_array_equal(xyz_t.numpy(), xyz_j)

    pmask, p_aabb, p_occ = tcull.update_alpha_mask(field, pprior, AABB, grid, step,
                                                  tuple(t(d) for d in den))
    jmask, j_aabb, j_occ = jcull.update_alpha_mask(JM, CFG, params, jprior, AABB, grid, step,
                                                   tuple(jnp.asarray(d) for d in den))
    # bits agree except where the pooled alpha lies within 1e-5 of the threshold
    pooled = np.asarray(jam.max_pool_3d_same(jnp.asarray(np.clip(alpha_j, 0, 1).transpose(2, 1, 0)), 3))
    differ = pmask.volume.numpy() != np.asarray(jmask.volume)
    assert not np.any(differ & (np.abs(pooled - CFG.alpha_mask_thres) > 1e-5))
    assert 0.01 < p_occ < 0.9  # the blob: a partial mask with a tight bbox
    assert p_occ == j_occ
    np.testing.assert_array_equal(p_aabb, j_aabb)
    np.testing.assert_array_equal(pmask.aabb.numpy(), np.asarray(jmask.aabb))
    np.testing.assert_array_equal(pmask.dilated.numpy(), np.asarray(jmask.dilated))


def test_filter_rays_alpha_keeps_the_jax_set(rng):
    jmask, pmask = random_mask(rng, (6, 7, 8))
    rays = _rays(rng, 700)
    rgbs = rng.uniform(size=(700, 3)).astype(np.float32)
    want_rays, want_rgbs = jcull.filter_rays_alpha(rays, rgbs, jmask, AABB, 0.05, (2.0, 6.0), chunk=256)
    got_rays, got_rgbs = tcull.filter_rays_alpha(t(rays), t(rgbs), pmask, AABB, 0.05, (2.0, 6.0), chunk=256)
    assert 0 < got_rays.shape[0] < 700
    np.testing.assert_array_equal(got_rays.numpy(), want_rays)
    np.testing.assert_array_equal(got_rgbs.numpy(), want_rgbs)


@pytest.mark.parametrize("keyed,top_k,fused", [(False, 16, True), (True, 16, True), (True, None, False)],
                         ids=["eval_topk", "jitter_topk", "jitter_unfused_all"])
def test_masked_render_matches_jax(rng, keyed, top_k, fused):
    cfg = dataclasses.replace(CFG, density_shift=-3.0)
    params = JM.init(jax.random.PRNGKey(3), cfg, (10, 12, 14))
    field = port_field(params, cfg)
    jmask, pmask = random_mask(rng)
    rays = _rays(rng, 48)
    key = jax.random.PRNGKey(7) if keyed else None
    u = flip = None
    if keyed:
        k_strat, k_bg = jax.random.split(key)
        u = t(jax.random.uniform(k_strat, (48, 1), dtype=jnp.float32))
        flip = t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32))
    kw = dict(step_size=0.06, n_samples=80, is_train=keyed, white_bg=True, ndc_ray=False,
              shade_top_k=top_k, fused=fused)
    want = j_render(JM, cfg, params, jmask, jnp.asarray(rays), key, JMasks(), aabb=jnp.asarray(AABB), **kw)
    got = t_render(field, t(rays), TMasks(), aabb=t(AABB), alpha_mask=pmask, u=u, flip=flip, **kw)
    for name in ("rgb", "depth", "acc", "weights", "sigma", "z_vals"):
        close(getattr(got, name), getattr(want, name))
    assert int(got.num_valid_samples) == int(want.num_valid_samples)
    close(got.mean_alive_samples, want.mean_alive_samples)
    # the mask culls: fewer live samples than without it
    free = t_render(field, t(rays), TMasks(), aabb=t(AABB), u=u, flip=flip, **kw)
    assert float(got.mean_alive_samples) < float(free.mean_alive_samples)


# ---- the schedule events -----------------------------------------------------

EVENT_OVERRIDES = dict(
    stratify=0, n_iters=20, N_voxel_init=16**3, N_voxel_final=22**3,
    update_AlphaMask_list=[2, 4], upsamp_list=[3], batch_size=64, downsample_train=1,
    n_lamb_sigma=[2, 3, 4], n_lamb_sh=[4, 3, 2], data_dim_color=6, featureC=16,
    density_shift=-10.0, basedir="unused",
)


def _jax_shrink(geometry, new_aabb, params, model_cfg, step_ratio):
    """tensorf_tpu loop.py:1234-1260 verbatim."""
    old = geometry
    units = old.units
    t_l = np.round(np.round((new_aabb[0] - old.aabb_np[0]) / units)).astype(np.int64)
    b_r = np.round((new_aabb[1] - old.aabb_np[0]) / units).astype(np.int64) + 1
    b_r = np.minimum(b_r, np.asarray(old.grid_size))
    params = JM.shrink(model_cfg, params, tuple(t_l.tolist()), tuple(b_r.tolist()))
    gs_arr = np.asarray(old.grid_size, np.float64)
    t_l_r = t_l / (gs_arr - 1)
    b_r_r = (b_r - 1) / (gs_arr - 1)
    corrected = np.stack([
        (1 - t_l_r) * old.aabb_np[0] + t_l_r * old.aabb_np[1],
        (1 - b_r_r) * old.aabb_np[0] + b_r_r * old.aabb_np[1],
    ])
    return params, JGeometry.create(corrected, tuple((b_r - t_l).tolist()), step_ratio)


@pytest.mark.parametrize("lr_upsample_reset", [1, 0], ids=["lr_reset", "lr_scaled"])
def test_schedule_events_match_the_jax_loop(lr_upsample_reset):
    """Mask (shrink) at 2, upsample at 3, mask (re-filter) at 4: grid, aabb,
    n_samples, L1 weight, factors, mask bits, ray store and the LR after
    each optimizer reset, against the JAX loop's event code on the same
    pre-event params."""
    over = dict(EVENT_OVERRIDES, lr_upsample_reset=lr_upsample_reset)
    scene = make_synthetic_scene_arrays(n_train=2, n_test=1, wh=(24, 24))
    tcfg = t_load_config("configs/synth_sphere.txt", over)
    jcfg = j_load_config("configs/synth_sphere.txt", over)
    state = tloop.TrainState(tcfg, torch.device("cpu"), scene)
    assert state.geometry.grid_size == (16, 16, 16)
    assert tloop.build_statics(state).shade_top_k == tcfg.prefilter_shade_top_k == 64
    model_cfg = j_model_config_from(jcfg).replace(near_far=state.near_far)
    params = blob_params(2, (16, 16, 16), model_cfg)
    state.field.load_state_dict(params_from_jax(_flat(params)))
    assert dataclasses.asdict(state.field.cfg) == dataclasses.asdict(model_cfg)

    # the JAX loop's state, from the same start
    geometry = JGeometry.create(AABB, (16, 16, 16), jcfg.step_ratio)
    n_samples = min(int(jcfg.nSamples), j_cal_n_samples(geometry.grid_size, jcfg.step_ratio))
    n_voxel_list = j_n_voxel_schedule(jcfg.N_voxel_init, jcfg.N_voxel_final, len(jcfg.upsamp_list))
    l1, jmask = jcfg.L1_weight_inital, None
    rays, rgbs = state.rays.numpy(), state.rgbs.numpy()

    def jax_mask_event(it):
        nonlocal jmask, params, geometry, l1, rays, rgbs
        den = tuple(jnp.asarray(m) for m in j_free_masks(
            model_cfg.pos_bit_length, model_cfg.view_bit_length, model_cfg.fea_bit_length,
            model_cfg.density_n_comp, model_cfg.app_n_comp, jnp.asarray(it), jcfg.n_iters,
            float(jcfg.freq_reg_ratio)).den)
        jmask, new_aabb, occ = jcull.update_alpha_mask(
            JM, model_cfg, params, jmask, geometry.aabb_np, geometry.grid_size,
            geometry.step_size, den)
        if it == jcfg.update_AlphaMask_list[0]:
            params, geometry = _jax_shrink(geometry, new_aabb, params, model_cfg, jcfg.step_ratio)
        if it == jcfg.update_AlphaMask_list[1]:
            rays, rgbs = jcull.filter_rays_alpha(rays, rgbs, jmask, geometry.aabb_np,
                                                 geometry.step_size, state.near_far)
        l1 = jcfg.L1_weight_rest
        return occ

    def check(lr_scale):
        assert state.geometry.grid_size == geometry.grid_size
        np.testing.assert_array_equal(state.geometry.aabb_np, geometry.aabb_np)
        assert state.n_samples == n_samples
        assert state.l1_weight == l1 and tloop.build_statics(state).weights.l1 == l1
        np.testing.assert_array_equal(state.alpha_mask.volume.numpy(), np.asarray(jmask.volume))
        np.testing.assert_array_equal(state.alpha_mask.aabb.numpy(), np.asarray(jmask.aabb))
        got = params_to_jax(state.field)
        for k, v in _flat(params).items():
            close(got[k], v)
        # a fresh optimizer: LR lr0 * lr_scale, count 0, no moments
        lrs = [g["lr"] for g in state.optimizer.adam.param_groups]
        np.testing.assert_allclose(lrs, [jcfg.lr_init * lr_scale, jcfg.lr_basis * lr_scale], rtol=1e-12)
        assert state.optimizer.schedule.last_epoch == 0 and not state.optimizer.adam.state
        np.testing.assert_array_equal(state.rays.numpy(), rays)
        np.testing.assert_array_equal(state.rgbs.numpy(), rgbs)

    occ = jax_mask_event(2)
    rec = tloop.alpha_mask_event(state, 2)
    assert rec["occupancy"] == occ and rec["shrink_grid"] == geometry.grid_size
    assert geometry.grid_size != (16, 16, 16)  # the blob's bbox is tight
    check(1.0)
    assert tcfg.shade_top_k == 0 and tloop.build_statics(state).shade_top_k is None

    # upsample at 3 on the shrunk aabb (tensorf_tpu loop.py:1307-1336)
    new_grid = j_n_to_reso(n_voxel_list.pop(0), geometry.aabb_np)
    n_samples = min(int(jcfg.nSamples), j_cal_n_samples(new_grid, jcfg.step_ratio))
    params = j_upsample(model_cfg, params, new_grid)
    geometry = JGeometry.create(geometry.aabb_np, new_grid, jcfg.step_ratio)
    lr_scale = 1.0 if jcfg.lr_upsample_reset else jcfg.lr_decay_target_ratio ** (3 / jcfg.n_iters)
    tloop.upsample_event(state, 3)
    check(lr_scale)

    n_before = state.rays.shape[0]
    jax_mask_event(4)
    tloop.alpha_mask_event(state, 4)
    check(lr_scale)  # no shape change: the optimizer stays as the upsample left it
    assert state.rays.shape[0] < n_before  # the mask re-filters the store
