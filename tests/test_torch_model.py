"""Parity of the port's TensorVMSplit and renderer with tensorf_tpu's.

The port's field loads the JAX field's params through
``convert.params_from_jax``; features, regularizers and renders then agree
within rtol/atol 1e-5 (forward, float32).  The port also keeps the
fused == unfused invariant tests/test_fused.py pins for JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models.tensorf import spatial_label_tree as j_labels
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import TensorVMSplit, spatial_label_tree
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.render import render_rays as t_render

FWD = dict(rtol=1e-5, atol=1e-5)
CFG = ModelConfig(
    model_name="TensorVMSplit",
    density_n_comp=(2, 3, 4),
    app_n_comp=(4, 3, 2),
    app_dim=6,
    shading_mode="MLP_Fea",
    pos_pe=2,
    view_pe=2,
    fea_pe=2,
    feature_c=16,
    density_shift=-3.0,
)
GRID = (10, 12, 14)
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
JM = FIELD_MODELS["TensorVMSplit"]


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=FWD):
    got, want = (x.detach().numpy() if isinstance(x, torch.Tensor) else x for x in (got, want))
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def jax_and_port(seed, cfg=CFG, grid=GRID):
    params = JM.init(jax.random.PRNGKey(seed), cfg, grid)
    flat = {}
    _flatten("", params, flat)
    field = TensorVMSplit(TConfig(**dataclasses.asdict(cfg)), grid, device="cpu")
    field.load_state_dict(params_from_jax(flat))
    return params, field


def rank_masks(rng, ranks):
    arrs = [rng.uniform(size=(r,)).astype(np.float32) for r in ranks]
    return tuple(jnp.asarray(a) for a in arrs), tuple(t(a) for a in arrs)


def test_params_from_jax_carries_every_leaf_and_label():
    params, field = jax_and_port(0)
    flat = {}
    _flatten("", params, flat)
    state = field.state_dict()
    assert set(state) == {k.replace("/", ".") for k in flat}
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k.replace("/", ".")].numpy(), v)
    jl = {}
    _flatten("", j_labels(params), jl)
    assert spatial_label_tree(field) == {k.replace("/", "."): v for k, v in jl.items()}
    assert field.grid_size == GRID


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "rank_masks"])
def test_features_match_jax_and_fused_equals_unfused(rng, masked):
    params, field = jax_and_port(1)
    xyz = rng.uniform(-1, 1, size=(123, 3)).astype(np.float32)
    (jd, td), (ja, ta) = (
        (rank_masks(rng, CFG.density_n_comp), rank_masks(rng, CFG.app_n_comp))
        if masked else ((None, None), (None, None))
    )
    x = t(xyz)
    pairs = [
        (field.density_feature(x, td), JM.density_feature(CFG, params, xyz, jd)),
        (field.app_feature(x, ta), JM.app_feature(CFG, params, xyz, ja)),
        (field.density_feature_fused(x, td), JM.density_feature_fused(CFG, params, xyz, jd)),
        (field.app_feature_fused(x, ta), JM.app_feature_fused(CFG, params, xyz, ja)),
    ]
    for got, want in pairs:
        close(got, want)
    # fused == unfused inside the port (tests/test_fused.py's invariant)
    close(pairs[2][0], pairs[0][0], dict(rtol=1e-4, atol=1e-5))
    close(pairs[3][0], pairs[1][0], dict(rtol=1e-4, atol=1e-5))


def test_regularizers_match_jax():
    params, field = jax_and_port(2)
    close(field.ortho_reg(), JM.ortho_reg(params))
    close(field.density_l1(), JM.density_l1(params))
    close(field.tv_density(), JM.tv_density(params))
    close(field.tv_app(), JM.tv_app(params))


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return np.concatenate([o, d], -1).astype(np.float32)


@pytest.mark.parametrize(
    "fused,top_k,keyed,white_bg",
    [
        (True, 16, False, True),
        (True, 16, True, True),
        (True, None, True, True),
        (False, 16, True, True),
        (False, None, False, True),
        (True, 16, True, False),
    ],
    ids=["fused_topk_eval", "fused_topk_jitter", "fused_all_jitter",
         "unfused_topk_jitter", "unfused_all_eval", "bg_flip"],
)
def test_render_rays_matches_jax(rng, fused, top_k, keyed, white_bg):
    params, field = jax_and_port(3)
    rays = _rays(rng, 32)
    B = rays.shape[0]
    key = jax.random.PRNGKey(7) if keyed else None
    u = flip = None
    if keyed:
        # render_rays splits its key: the first half draws the jitter, the
        # second the background flip
        k_strat, k_bg = jax.random.split(key)
        u = t(jax.random.uniform(k_strat, (B, 1), dtype=jnp.float32))
        flip = t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32))
    kw = dict(step_size=0.06, n_samples=80, is_train=keyed, white_bg=white_bg,
              ndc_ray=False, shade_top_k=top_k, fused=fused)
    want = j_render(JM, CFG, params, None, jnp.asarray(rays), key, JMasks(),
                    aabb=jnp.asarray(AABB), **kw)
    got = t_render(field, t(rays), TMasks(), aabb=t(AABB), u=u, flip=flip, **kw)
    for name in ("rgb", "depth", "acc", "weights", "sigma", "z_vals"):
        close(getattr(got, name), getattr(want, name))
    assert int(got.num_valid_samples) == int(want.num_valid_samples)
    close(got.mean_alive_samples, want.mean_alive_samples)


def test_render_rays_raises_on_what_is_not_ported():
    """NDC rays, once refused, render as JAX renders them (with and without
    a budget; tests/test_torch_ndc.py pins every NDC mode and gradient);
    what JAX refuses stays refused."""
    params, field = jax_and_port(4)
    rays_np = _rays(np.random.default_rng(0), 4)
    rays = t(rays_np)
    kw = dict(aabb=t(AABB), step_size=0.06, n_samples=40, is_train=False, white_bg=True)
    # sample budgets are ported: the mask-free budget compacts to its width
    out = t_render(field, rays, TMasks(), sample_budget=16, **kw)
    assert out.z_vals.shape == (4, 16)
    ndc_cfg = dataclasses.replace(CFG, near_far=(0.0, 1.0))
    field.cfg = TConfig(**dataclasses.asdict(ndc_cfg))
    for extra in (dict(sample_budget=16, ndc_ray=True), dict(ndc_ray=True)):
        got = t_render(field, rays, TMasks(), **kw, **extra)
        want = j_render(JM, ndc_cfg, params, None, jnp.asarray(rays_np), None, JMasks(),
                        aabb=jnp.asarray(AABB), **{k: v for k, v in kw.items() if k != "aabb"},
                        **extra)
        for name in ("rgb", "depth", "weights", "z_vals"):
            close(getattr(got, name), getattr(want, name))
    # serving window bits are ported; without an alpha mask they are refused,
    # as the JAX renderer refuses them
    with pytest.raises(ValueError, match="cand_window_bits"):
        t_render(field, rays, TMasks(), sample_budget=16, budget_mode="cand",
                 cand_window_bits=t(np.zeros((4, 2), np.uint8)), **kw)
