"""Parity of the port's TensorCP and TensorVM with tensorf_tpu's.

Each port field loads the JAX field's params through
``convert.params_from_jax``.  Every feature method (with and without the
FreeNeRF rank masks, which TensorVM ignores in both packages), the
regularizers, upsample and shrink, and ``render_rays`` in its top-K,
full-shading, unfused and budgeted (stratified) paths then agree within
rtol/atol 1e-5 (depth 1e-4, as tests/test_torch_stratified.py holds it).
The port keeps tests/test_fused.py's fused == unfused invariant (TensorVM
on a cubic grid, as there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models import alpha_mask as jam
from tensorf_tpu.models.tensorf import spatial_label_tree as j_labels
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.models import FIELD_MODELS as T_MODELS
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.models import spatial_label_tree
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.render import render_rays as t_render

FWD = dict(rtol=1e-5, atol=1e-5)
COMMON = dict(pos_pe=2, view_pe=2, fea_pe=2, feature_c=16, density_shift=-3.0)
CONFIGS = {
    "TensorCP": ModelConfig(model_name="TensorCP", density_n_comp=(5,), app_n_comp=(7,),
                            app_dim=6, shading_mode="MLP", **COMMON),
    "TensorVM": ModelConfig(model_name="TensorVM", density_n_comp=(3,), app_n_comp=(4,),
                            app_dim=27, shading_mode="SH", **COMMON),
}
GRID = (10, 12, 14)
CUBE = (12, 12, 12)
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
MODELS = list(CONFIGS)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=FWD):
    got, want = (x.detach().numpy() if isinstance(x, torch.Tensor) else x for x in (got, want))
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def _flat(params):
    out = {}
    _flatten("", params, out)
    return out


def jax_and_port(model, seed, grid=GRID, cfg=None):
    cfg = cfg or CONFIGS[model]
    params = FIELD_MODELS[model].init(jax.random.PRNGKey(seed), cfg, grid)
    field = T_MODELS[model](TConfig(**dataclasses.asdict(cfg)), grid, device="cpu")
    field.load_state_dict(params_from_jax(_flat(params)))
    return cfg, params, field


def rank_masks(rng, ranks):
    arrs = [rng.uniform(size=(r,)).astype(np.float32) for r in ranks]
    return tuple(jnp.asarray(a) for a in arrs), tuple(t(a) for a in arrs)


@pytest.mark.parametrize("model", MODELS)
def test_fresh_fields_have_the_jax_layout(model):
    """A fresh port field has the JAX init's leaves, shapes and optimizer
    labels, and the JAX init's scale (0.2 randn CP lines, 0.1 randn VM
    factors)."""
    cfg, params, field = jax_and_port(model, 0)
    flat = _flat(params)
    fresh = T_MODELS[model](TConfig(**dataclasses.asdict(cfg)), GRID, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    shapes = {k.replace(".", "/"): tuple(v.shape) for k, v in fresh.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in flat.items()}
    jl = _flat(j_labels(params))
    assert spatial_label_tree(fresh) == {k.replace("/", "."): v for k, v in jl.items()}
    assert fresh.grid_size == GRID and fresh.has_ortho == FIELD_MODELS[model].has_ortho
    factor = "density_line" if model == "TensorCP" else "plane"
    got = torch.cat([p.reshape(-1) for p in getattr(fresh, factor)]).std().item()
    want = float(np.concatenate([np.ravel(flat[f"{factor}/{i}"]) for i in range(3)]).std())
    assert 0.75 < got / want < 1.33  # 0.2 and 0.1 lie 2x apart
    for k, v in flat.items():
        np.testing.assert_array_equal(field.state_dict()[k.replace("/", ".")].numpy(), v)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "rank_masks"])
@pytest.mark.parametrize("model", MODELS)
def test_features_match_jax(rng, model, masked):
    cfg, params, field = jax_and_port(model, 1)
    JM = FIELD_MODELS[model]
    xyz = rng.uniform(-1, 1, size=(123, 3)).astype(np.float32)
    (jd, td), (ja, ta) = (
        (rank_masks(rng, cfg.density_n_comp), rank_masks(rng, cfg.app_n_comp))
        if masked else ((None, None), (None, None))
    )
    x = t(xyz)
    pairs = [
        (field.density_feature(x, td), JM.density_feature(cfg, params, xyz, jd)),
        (field.app_feature(x, ta), JM.app_feature(cfg, params, xyz, ja)),
        (field.density_feature_fused(x, td), JM.density_feature_fused(cfg, params, xyz, jd)),
        (field.app_feature_fused(x, ta), JM.app_feature_fused(cfg, params, xyz, ja)),
    ]
    for got, want in pairs:
        close(got, want)
    if masked and model == "TensorVM":
        # TensorVM reads no rank mask, in either package
        for got, plain in ((field.density_feature(x, td), field.density_feature(x, None)),
                           (field.app_feature_fused(x, ta), field.app_feature_fused(x, None)),
                           (field.density_feature_fused(x, td),
                            field.density_feature_fused(x, None))):
            assert torch.equal(got, plain)
    if masked and model == "TensorCP":
        # CP's mask applies once, its first entry, to the line product
        assert not torch.allclose(field.density_feature(x, td), field.density_feature(x, None))


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "rank_masks"])
@pytest.mark.parametrize("model", MODELS)
def test_fused_equals_unfused(rng, model, masked):
    cfg, _, field = jax_and_port(model, 2, grid=CUBE if model == "TensorVM" else GRID)
    x = t(rng.uniform(-1, 1, size=(200, 3)).astype(np.float32))
    td = rank_masks(rng, cfg.density_n_comp)[1] if masked else None
    ta = rank_masks(rng, cfg.app_n_comp)[1] if masked else None
    tol = dict(rtol=1e-4, atol=1e-5)
    close(field.density_feature_fused(x, td), field.density_feature(x, td), tol)
    close(field.app_feature_fused(x, ta), field.app_feature(x, ta), tol)


@pytest.mark.parametrize("model", MODELS)
def test_regularizers_match_jax(model):
    _, params, field = jax_and_port(model, 3)
    JM = FIELD_MODELS[model]
    close(field.density_l1(), JM.density_l1(params))
    close(field.tv_density(), JM.tv_density(params))
    close(field.tv_app(), JM.tv_app(params))
    if model == "TensorVM":
        close(field.ortho_reg(), JM.ortho_reg(params))
        assert float(field.tv_app()) == 0.0
    else:
        assert not field.has_ortho and not hasattr(field, "ortho_reg")


@pytest.mark.parametrize("model", MODELS)
def test_upsample_and_shrink_match_jax(model):
    cfg, params, field = jax_and_port(model, 4)
    JM = FIELD_MODELS[model]
    params = JM.upsample(cfg, params, (13, 15, 17))
    field.upsample((13, 15, 17))
    assert field.grid_size == (13, 15, 17) == JM.grid_size_of(params)
    t_l, b_r = (2, 1, 3), (11, 15, 14)
    params = JM.shrink(cfg, params, t_l, b_r)
    field.shrink(t_l, b_r)
    assert field.grid_size == (9, 14, 11) == JM.grid_size_of(params)
    state = field.state_dict()
    flat = _flat(params)
    assert set(state) == {k.replace("/", ".") for k in flat}
    for k, v in flat.items():
        close(state[k.replace("/", ".")], v)
    # the events replace the factors with fresh leaf Parameters
    assert all(p.is_leaf and p.requires_grad for p in field.parameters())


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return np.concatenate([o, d], -1).astype(np.float32)


RENDER_CASES = {
    # name: (alpha mask, render keywords)
    "fused_topk": (False, dict(shade_top_k=16, fused=True)),
    "fused_all": (False, dict(shade_top_k=None, fused=True)),
    "unfused_topk": (False, dict(shade_top_k=16, fused=False)),
    "cand_windows": (True, dict(shade_top_k=16, fused=True, sample_budget=48,
                                budget_mode="cand")),
    "alive_two_stage": (True, dict(shade_top_k=16, fused=True, sample_budget=32,
                                   budget_mode="alive")),
    "prefilter_windows": (False, dict(shade_top_k=None, fused=True, sample_budget=64,
                                      budget_mode="cand")),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
@pytest.mark.parametrize("model", MODELS)
def test_render_rays_matches_jax(rng, model, case):
    cfg, params, field = jax_and_port(model, 5, grid=CUBE)
    masked, extra = RENDER_CASES[case]
    jmask = pmask = None
    if masked:
        vol = (np.random.default_rng(7).uniform(size=(10, 10, 10)) < 0.35).astype(np.float32)
        jmask = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(AABB),
                                                    volume=jnp.asarray(vol)))
        pmask = tam.with_dilation(tam.AlphaGridMask(aabb=t(AABB), volume=t(vol)))
    rays = _rays(rng, 48)
    key = jax.random.PRNGKey(9)
    k_strat, k_bg = jax.random.split(key)
    u = t(jax.random.uniform(k_strat, (48, 1), dtype=jnp.float32))
    flip = t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32))
    kw = dict(step_size=0.05, n_samples=128, is_train=True, white_bg=True, ndc_ray=False, **extra)
    want = j_render(FIELD_MODELS[model], cfg, params, jmask, jnp.asarray(rays), key, JMasks(),
                    aabb=jnp.asarray(AABB), **kw)
    with torch.no_grad():
        got = t_render(field, t(rays), TMasks(), aabb=t(AABB), alpha_mask=pmask, u=u, flip=flip,
                       **kw)
    close(got.rgb, want.rgb)
    close(got.depth, want.depth, dict(rtol=1e-4, atol=1e-4))
    for name in ("acc", "weights", "sigma", "z_vals"):
        close(getattr(got, name), getattr(want, name))
    assert int(got.num_valid_samples) == int(want.num_valid_samples)
    assert float(got.budget_overflow_frac) == float(want.budget_overflow_frac)


def test_unknown_models_are_refused():
    cfg = TConfig(model_name="TensorCP")
    with pytest.raises(ValueError, match="TensorVM"):
        T_MODELS["TensorVM"](cfg, GRID, device="cpu")
    with pytest.raises(ValueError, match="unknown dtype"):
        T_MODELS["TensorCP"](dataclasses.replace(cfg, line_dtype="float16"), GRID, device="cpu")
    assert set(T_MODELS) == set(FIELD_MODELS)
