"""Parity of the port's bfloat16 paths with tensorf_tpu's.

``grid_dtype`` casts TensorVMSplit's plane tables to bf16 in its fused
paths, ``line_dtype`` (or the legacy blanket ``grid_dtype``) builds the
line one-hot in bf16 with a float32 product, and ``dtype`` runs the
shading MLP in bf16 with its sigmoid in float32.  Both packages round the
same float32 tables to bf16 and lerp or multiply in float32, so the fields'
forward agrees within rtol/atol 1e-5.  The MLP in bf16 rounds at other
places in the two frameworks (bias adds, the layers' outputs), so heads and
one step's gradients agree within bf16 tolerance: 2e-2 relative.  The
gradients also differ by where the plane-row sums round: JAX sums the bf16
tap gradients in bf16 (the transpose of its gather), the port in float32
(the scatter-add's bf16 entry point) and rounds once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models.shading import apply_shading as j_apply
from tensorf_tpu.models.shading import init_shading as j_init
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.ops.grid_sample import line_sample_matmul as j_line_matmul
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.train import LossWeights as JWeights
from tensorf_tpu.train import TrainStatics as JStatics
from tensorf_tpu.train import make_train_step as j_make_train_step
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch import __main__ as cli
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.models import FIELD_MODELS as T_MODELS
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models.shading import MODES, apply_shading, init_shading
from tensorf_tpu_torch.models.tensorf import line_a_dtype, line_uses_matmul
from tensorf_tpu_torch.ops import grid_sample
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.ops.grid_sample import line_sample_matmul
from tensorf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_bf16
from tensorf_tpu_torch.ops.scatter_add import scatter_add_reference
from tensorf_tpu_torch.render import render_rays as t_render
from tensorf_tpu_torch.train import LossWeights as TWeights
from tensorf_tpu_torch.train import TrainStatics as TStatics
from tensorf_tpu_torch.train import loss_fn

FWD = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2  # bf16 keeps 8 bits: 2^-8 relative per rounding, a few roundings deep
COMMON = dict(pos_pe=2, view_pe=2, fea_pe=2, feature_c=16, density_shift=-3.0)
CONFIGS = {
    "TensorVMSplit": ModelConfig(model_name="TensorVMSplit", density_n_comp=(2, 3, 4),
                                 app_n_comp=(4, 3, 2), app_dim=6, shading_mode="MLP_Fea",
                                 **COMMON),
    "TensorCP": ModelConfig(model_name="TensorCP", density_n_comp=(5,), app_n_comp=(7,),
                            app_dim=6, shading_mode="MLP", **COMMON),
    "TensorVM": ModelConfig(model_name="TensorVM", density_n_comp=(3,), app_n_comp=(4,),
                            app_dim=27, shading_mode="SH", **COMMON),
}
GRID = (10, 12, 14)
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    out = {}
    _flatten(prefix, tree, out)
    return out


def jax_and_port(model, seed, cfg=None, grid=GRID):
    cfg = cfg or CONFIGS[model]
    params = FIELD_MODELS[model].init(jax.random.PRNGKey(seed), cfg, grid)
    field = T_MODELS[model](TConfig(**dataclasses.asdict(cfg)), grid, device="cpu")
    field.load_state_dict(params_from_jax(_flat(params)))
    return params, field


def close(got, want, tol=FWD):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def bf16_close(got, want, rel=BF16_REL):
    """|got - want| <= rel * max|want| + 1e-6, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + 1e-6, (err, float(np.abs(want).max()))


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return np.concatenate([o, d], -1).astype(np.float32)


@pytest.mark.parametrize("knob", ["grid_dtype", "line_dtype"])
@pytest.mark.parametrize("model", list(CONFIGS))
def test_bf16_fused_features_match_jax(rng, model, knob):
    """Every fused feature path under a bf16 knob: both packages round the
    same float32 tables to bf16 and lerp in float32 (the one-hot product
    of bf16 operands is exact in float32), so float32-tight."""
    cfg = dataclasses.replace(CONFIGS[model], **{knob: "bfloat16"})
    params, field = jax_and_port(model, 1, cfg)
    JM = FIELD_MODELS[model]
    xyz = rng.uniform(-1, 1, size=(123, 3)).astype(np.float32)
    x = t(xyz)
    assert field.line_a_dtype == torch.bfloat16
    assert field.grid_dtype == (torch.bfloat16 if knob == "grid_dtype" else torch.float32)
    pairs = [
        (field.density_feature_fused(x, None), JM.density_feature_fused(cfg, params, xyz, None)),
        (field.app_feature_fused(x, None), JM.app_feature_fused(cfg, params, xyz, None)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        close(got, want)
    # the bf16 knob moved the features off the float32 ones (it did cast)
    f32 = T_MODELS[model](TConfig(**dataclasses.asdict(CONFIGS[model])), GRID, device="cpu")
    f32.load_state_dict(field.state_dict())
    assert not torch.equal(f32.density_feature_fused(x, None), pairs[0][0])


@pytest.mark.parametrize("model,knob,bar", [
    ("TensorVMSplit", "grid_dtype", 0.03),
    ("TensorVMSplit", "line_dtype", 0.02),
    ("TensorCP", "line_dtype", 0.02),
    ("TensorVM", "line_dtype", 0.02),
])
def test_bf16_renders_stay_near_float32_and_match_jax(rng, model, knob, bar):
    """A bf16 render against the float32 render of the same field, inside
    JAX's own bars (tests/test_render.py: 0.03 grid, 0.02 line), and
    against JAX's bf16 render within rtol/atol 1e-5 (depth 1e-4)."""
    cfg = dataclasses.replace(CONFIGS[model], shading_mode="MLP_Fea", feature_c=32)
    bf = dataclasses.replace(cfg, **{knob: "bfloat16"})
    params, field = jax_and_port(model, 1, cfg)
    _, field_bf = jax_and_port(model, 1, bf)
    rays = _rays(rng, 32)
    kw = dict(step_size=0.06, n_samples=64, is_train=False, white_bg=True, ndc_ray=False)
    with torch.no_grad():
        a = t_render(field, t(rays), TMasks(), aabb=t(AABB), **kw)
        b = t_render(field_bf, t(rays), TMasks(), aabb=t(AABB), **kw)
    err = float((a.rgb - b.rgb).abs().max())
    assert err < bar, err
    want = j_render(FIELD_MODELS[model], bf, params, None, jnp.asarray(rays), None, JMasks(),
                    aabb=jnp.asarray(AABB), **kw)
    close(b.rgb, want.rgb)
    close(b.depth, want.depth, dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("mode", MODES)
def test_bf16_heads_match_jax(rng, mode):
    """dtype bfloat16: the MLP heads compute in bf16 (weights cast per
    layer) with the sigmoid in float32; SH and RGB read no dtype.  Output
    float32, within bf16 tolerance of JAX's."""
    app_dim = {"SH": 27, "RGB": 3}.get(mode, 6)
    cfg = ModelConfig(shading_mode=mode, app_dim=app_dim, pos_pe=2, view_pe=3, fea_pe=2,
                      feature_c=16, dtype="bfloat16")
    params = j_init(jax.random.PRNGKey(1), cfg)
    mlp = init_shading(TConfig(**dataclasses.asdict(cfg)), torch.Generator())
    mlp.load_state_dict({k[len("render."):]: v
                         for k, v in params_from_jax(_flat(params, "render")).items()})
    n = 96
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    view = rng.normal(size=(n, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    feat = rng.normal(scale=0.5, size=(n, app_dim)).astype(np.float32)
    want = j_apply(cfg, params, jnp.asarray(pts), jnp.asarray(view), jnp.asarray(feat), JMasks())
    got = apply_shading(TConfig(**dataclasses.asdict(cfg)), mlp, t(pts), t(view), t(feat),
                        TMasks())
    assert got.dtype == torch.float32
    if mode in ("SH", "RGB"):
        close(got, want)
    else:
        bf16_close(got, want)
        # the parameters stay float32
        assert all(p.dtype == torch.float32 for p in mlp.parameters())


def _capture_grads():
    """An optax transform that stores the gradients and updates nothing."""

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


STATICS = dict(n_samples=64, step_size=0.08, white_bg=True, ndc_ray=False, total_steps=100,
               lr_factor=0.99, free_reg=True, free_decomp=True, freq_reg_ratio=0.8,
               shade_top_k=16, fused=True)
WEIGHTS = dict(ortho=0.01, l1=8e-5, tv_density=0.01, tv_app=0.01, occ=0.1, occ_range=5)
BF16_STEPS = {
    "grid": dict(grid_dtype="bfloat16"),
    "line": dict(line_dtype="bfloat16"),
    "compute": dict(dtype="bfloat16"),
    "all": dict(grid_dtype="bfloat16", line_dtype="bfloat16", dtype="bfloat16"),
}


@pytest.mark.parametrize("knobs", list(BF16_STEPS))
def test_bf16_step_gradients_match_jax(rng, knobs):
    """One TensorVMSplit step under each bf16 setting: the loss within
    bf16 tolerance of JAX's, every leaf's gradient within 2e-2 of its
    largest JAX gradient; a bf16 grid sends its plane rows' gradients
    through the bf16 entry point (6 scatter-adds of bf16 g a step)."""
    cfg = dataclasses.replace(CONFIGS["TensorVMSplit"], **BF16_STEPS[knobs])
    params, field = jax_and_port("TensorVMSplit", 0, cfg, grid=(16, 16, 16))
    rays, rgbs = _rays(rng, 64), rng.uniform(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    tx = _capture_grads()
    j_step = j_make_train_step(FIELD_MODELS["TensorVMSplit"], cfg,
                               JStatics(weights=JWeights(**WEIGHTS), **STATICS), tx)
    _, opt_state, metrics = j_step(params, tx.init(params), None, jnp.asarray(AABB),
                                   jnp.asarray(rays), jnp.asarray(rgbs), jnp.asarray(3), key)
    j_grads = {k.replace("/", "."): v for k, v in _flat(opt_state["g"]).items()}
    k_strat, k_bg = jax.random.split(key)
    u = t(jax.random.uniform(k_strat, (64, 1), dtype=jnp.float32))
    flip = t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32))
    dtypes = []

    def recording(idx, g, n_rows):
        dtypes.append(g.dtype)
        return scatter_add_reference(idx, g, n_rows)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(grid_sample, "scatter_add", recording)
        total, _ = loss_fn(field, TStatics(weights=TWeights(**WEIGHTS), **STATICS), t(AABB),
                           t(rays), t(rgbs), 3, u, flip)
        total.backward()
    np.testing.assert_allclose(float(total.detach()), float(metrics["total_loss"]),
                               rtol=BF16_REL)
    want_dtype = torch.bfloat16 if cfg.grid_dtype == "bfloat16" else torch.float32
    assert dtypes == [want_dtype] * 6
    grads = {n: p.grad for n, p in field.named_parameters()}
    assert set(grads) == set(j_grads)
    for n, g in grads.items():
        assert g.dtype == torch.float32, n
        bf16_close(g, j_grads[n])


def test_line_sample_matmul_bf16_output_is_float32(rng):
    """The bf16 one-hot product comes out in float32: equal to a float64
    product of the bf16-cast operands within float32 rounding (1e-6
    relative), where a bf16 result would be off by up to 2^-9; equal to
    JAX's; its line gradient is bf16-rounded float32 sums."""
    L, C, M = 37, 11, 500
    line = rng.normal(size=(L, C)).astype(np.float32)
    coord = rng.uniform(-1, 1, size=(M,)).astype(np.float32)
    got = line_sample_matmul(t(line), t(coord), torch.bfloat16)
    assert got.dtype == torch.float32
    # the same one-hot built in float64 from the bf16-rounded weights
    pos = (np.clip(coord, -1, 1) + 1.0) * 0.5 * (L - 1)
    i0 = np.floor(pos)
    w1 = (pos - i0).astype(np.float32)
    a = np.zeros((M, L))
    rows = np.arange(M)
    bf = lambda v: torch.tensor(v).to(torch.bfloat16).double().numpy()  # noqa: E731
    a[rows, i0.astype(int)] = bf(1.0 - w1)
    hi = i0.astype(int) + 1
    ok = hi < L
    a[rows[ok], hi[ok]] = bf(w1)[ok]
    exact = a @ bf(line)
    err = np.abs(got.double().numpy() - exact)
    assert float(err.max()) <= 1e-6 * float(np.abs(exact).max())
    as_bf16 = torch.tensor(exact).to(torch.bfloat16).double().numpy()
    assert float(np.abs(as_bf16 - exact).max()) > 100 * float(err.max())  # bf16 would show
    close(got, j_line_matmul(jnp.asarray(line), jnp.asarray(coord), a_dtype=jnp.bfloat16))
    # the gradient to a float32 line flows through the bf16 cast
    lt = t(line).requires_grad_(True)
    cot = rng.normal(size=(M, C)).astype(np.float32)
    (line_sample_matmul(lt, t(coord), torch.bfloat16) * t(cot)).sum().backward()
    want = jax.grad(lambda ln: jnp.sum(j_line_matmul(ln, jnp.asarray(coord),
                                                     a_dtype=jnp.bfloat16) * cot))(
        jnp.asarray(line))
    assert lt.grad.dtype == torch.float32
    bf16_close(lt.grad, want, rel=1e-2)


def test_bf16_scatter_add_plain_version_matches_add_at(rng):
    """The bf16 entry point's plain version (a CPU tensor): np.add.at of
    the bf16 values, summed in float32; scatter_add_bf16 refuses float32,
    and neither launches a kernel on the CPU."""
    M, R, C = 3000, 97, 24
    idx = rng.integers(0, R, size=M).astype(np.int32)
    g = torch.tensor(rng.normal(size=(M, C)).astype(np.float32)).to(torch.bfloat16)
    want = np.zeros((R, C), np.float64)
    np.add.at(want, idx, g.double().numpy())
    before = (scatter_add.launches, scatter_add_bf16.launches)
    for fn in (scatter_add, scatter_add_bf16):
        got = fn(t(idx), g, R)
        assert got.dtype == torch.float32 and got.shape == (R, C)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (scatter_add.launches, scatter_add_bf16.launches) == before
    with pytest.raises(ValueError, match="bfloat16"):
        scatter_add_bf16(t(idx), g.float(), R)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scatter_add(t(idx), g.half(), R)


def test_line_dispatch_counts_the_one_hot_element_size():
    """A bf16 one-hot is kept at 2 B an element: twice the points fit
    under the same bound (flower's 351..400 segment, models/tensorf.py)."""
    n = 6_336_512
    assert not line_uses_matmul(n, 315)
    assert line_uses_matmul(n, 315, torch.bfloat16)
    assert line_uses_matmul(n, 472, torch.bfloat16)
    assert not line_uses_matmul(n, 526, torch.bfloat16)
    assert not line_uses_matmul(9_474_048, 471, torch.bfloat16)
    cfg = TConfig()
    assert line_a_dtype(cfg) is None
    assert line_a_dtype(dataclasses.replace(cfg, grid_dtype="bfloat16")) == torch.bfloat16
    assert line_a_dtype(dataclasses.replace(cfg, line_dtype="bfloat16")) == torch.bfloat16
    with pytest.raises(ValueError, match="unknown dtype"):
        line_a_dtype(dataclasses.replace(cfg, line_dtype="float16"))


def test_cli_trains_and_serves_bf16_on_the_cpu(tmp_path, capsys):
    """configs/synth_sphere.txt with every dtype at bfloat16 through the
    CLI, tiny: it trains through its events, serves its test view and
    writes a float32 checkpoint that renders again through render-only."""
    import json

    argv = ["--config", "configs/synth_sphere.txt", "--device", "cpu", "--synthetic",
            "--synthetic_scene", "sphere", "--synthetic_wh", "32", "--synthetic_views", "3,1",
            "--downsample_train", "1", "--n_iters", "8", "--N_voxel_init", "1000",
            "--N_voxel_final", "4096", "--upsamp_list", "[3]", "--update_AlphaMask_list", "[5]",
            "--batch_size", "128", "--save_images", "0", "--basedir", str(tmp_path),
            "--grid_dtype", "bfloat16", "--line_dtype", "bfloat16",
            "--compute_dtype", "bfloat16"]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_test_psnr"])
    ckpt = out["final_ckpt"]
    data = np.load(ckpt)
    assert all(data[k].dtype == np.float32 for k in data.files if k.startswith("params/"))
    assert json.loads(bytes(data["kwargs"]).decode())["grid_dtype"] == "bfloat16"
    assert cli.main(argv + ["--render_only", "1", "--render_test", "1", "--ckpt", ckpt]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(again["test_psnr"] - out["final_test_psnr"]) <= 1e-4
