"""Parity of the port's train step (tensorf_tpu_torch/train) with tensorf_tpu's.

One step's gradients are compared with the JAX step's own
``jax.value_and_grad`` of its loss (captured through an optax transform
that records the gradients and applies nothing), for every parameter leaf,
within rtol/atol 1e-4.  The Adam update is compared on its own by feeding
both optimizers the same gradients: a first Adam step is about lr·sign(g),
so comparing params after two independent backward passes would be
ill-conditioned.
"""

import dataclasses
import glob
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorf_tpu.config.frontends import load_config as j_load_config
from tensorf_tpu.data.blender import BlenderDataset as JBlender
from tensorf_tpu.data.synthetic import make_synthetic_blender_scene
from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.train import LossWeights as JWeights
from tensorf_tpu.train import TrainStatics as JStatics
from tensorf_tpu.train import make_optimizer as j_make_optimizer
from tensorf_tpu.train import make_train_step as j_make_train_step
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch.config import load_config as t_load_config
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.data.blender import BlenderDataset as TBlender
from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import FIELD_MODELS as T_MODELS
from tensorf_tpu_torch.models import TensorVMSplit
from tensorf_tpu_torch.ops import grid_sample
from tensorf_tpu_torch.ops.scatter_add import scatter_add_reference
from tensorf_tpu_torch.train import LossWeights as TWeights
from tensorf_tpu_torch.train import SimpleSampler
from tensorf_tpu_torch.train import TrainStatics as TStatics
from tensorf_tpu_torch.train import loss_fn, make_optimizer, make_train_step
from tensorf_tpu_torch.train.loop import train_steps

GRAD = dict(rtol=1e-4, atol=1e-4)
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
GRID = (16, 16, 16)
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
JM = FIELD_MODELS["TensorVMSplit"]
STATICS = dict(
    n_samples=64, step_size=0.08, white_bg=True, ndc_ray=False, total_steps=100,
    lr_factor=0.99, free_reg=True, free_decomp=True, freq_reg_ratio=0.8,
    shade_top_k=16, fused=True,
)
WEIGHTS = dict(ortho=0.01, l1=8e-5, tv_density=0.01, tv_app=0.01, occ=0.1, occ_range=5)


def t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    out = {}
    _flatten("", tree, out)
    return {k.replace("/", "."): v for k, v in out.items()}


def _field(params):
    field = TensorVMSplit(TConfig(**dataclasses.asdict(CFG)), GRID, device="cpu")
    field.load_state_dict(params_from_jax(_flat(params)))
    return field


def _batch(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    rays = np.concatenate([o, d], -1).astype(np.float32)
    return rays, rng.uniform(size=(n, 3)).astype(np.float32)


def _capture_grads():
    """An optax transform that stores the gradients and updates nothing."""

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


@pytest.mark.parametrize("step", [3, 150], ids=["curriculum", "after_curriculum"])
def test_one_step_gradients_match_jax(rng, step):
    params = JM.init(jax.random.PRNGKey(0), CFG, GRID)
    rays, rgbs = _batch(rng, 64)
    key = jax.random.PRNGKey(11)
    field = _field(params)  # before the JAX step, which donates params
    statics = JStatics(weights=JWeights(**WEIGHTS), **STATICS)
    tx = _capture_grads()
    j_step = j_make_train_step(JM, CFG, statics, tx)
    _, opt_state, metrics = j_step(
        params, tx.init(params), None, jnp.asarray(AABB), jnp.asarray(rays),
        jnp.asarray(rgbs), jnp.asarray(step), key,
    )
    j_grads = _flat(opt_state["g"])

    # the JAX step hands its key to render_rays, which splits it
    k_strat, k_bg = jax.random.split(key)
    u = t(jax.random.uniform(k_strat, (64, 1), dtype=jnp.float32))
    flip = t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32))
    total, t_metrics = loss_fn(
        field, TStatics(weights=TWeights(**WEIGHTS), **STATICS), t(AABB), t(rays),
        t(rgbs), step, u, flip,
    )
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(metrics["total_loss"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(t_metrics["mse"].detach()), float(metrics["mse"]), rtol=1e-5, atol=1e-6)
    grads = {name: p.grad for name, p in field.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), j_grads[name], err_msg=name, **GRAD)


def test_adam_update_matches_optax_given_the_same_gradients(rng):
    params = JM.init(jax.random.PRNGKey(1), CFG, GRID)
    field = _field(params)
    tx, state = j_make_optimizer(params, 0.02, 1e-3, 0.9)
    opt = make_optimizer(field, 0.02, 1e-3, 0.9)
    for _ in range(3):  # three steps: the bias correction and LR decay move
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), params
        )
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        flat_g = _flat(grads)
        for name, p in field.named_parameters():
            p.grad = t(flat_g[name])
        opt.step()
        want = _flat(params)
        for name, p in field.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), want[name], rtol=1e-5, atol=1e-6, err_msg=name
            )


def test_loss_trajectory_follows_jax(rng):
    """25 steps from the same params, batches and noise: both packages walk
    the same loss curve (per-step total loss within 1e-3 relative; the
    float32 differences Adam amplifies stay far below that here)."""
    params = JM.init(jax.random.PRNGKey(3), CFG, GRID)
    field = _field(params)
    statics = dict(STATICS, lr_factor=0.999)
    tx, state = j_make_optimizer(params, 0.02, 1e-3, 0.999)
    j_step = j_make_train_step(JM, CFG, JStatics(weights=JWeights(**WEIGHTS), **statics), tx)
    opt = make_optimizer(field, 0.02, 1e-3, 0.999)
    t_statics = TStatics(weights=TWeights(**WEIGHTS), **statics)
    for it in range(25):
        rays, rgbs = _batch(rng, 64)
        key = jax.random.PRNGKey(100 + it)
        params, state, metrics = j_step(
            params, state, None, jnp.asarray(AABB), jnp.asarray(rays), jnp.asarray(rgbs),
            jnp.asarray(it), key,
        )
        k_strat, k_bg = jax.random.split(key)
        u = t(jax.random.uniform(k_strat, (64, 1), dtype=jnp.float32))
        flip = t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32))
        opt.zero_grad()
        total, _ = loss_fn(field, t_statics, t(AABB), t(rays), t(rgbs), it, u, flip)
        total.backward()
        opt.step()
        np.testing.assert_allclose(
            float(total.detach()), float(metrics["total_loss"]), rtol=1e-3, err_msg=f"step {it}"
        )


# TensorCP with MLP shading (configs/lego.txt's pair) and TensorVM with SH
OTHER_MODELS = {
    "TensorCP_MLP": dataclasses.replace(CFG, model_name="TensorCP", density_n_comp=(3,),
                                        app_n_comp=(5,), shading_mode="MLP"),
    "TensorVM_SH": dataclasses.replace(CFG, model_name="TensorVM", density_n_comp=(3,),
                                       app_n_comp=(4,), app_dim=27, shading_mode="SH"),
}
# scatter-adds of one fused top-K step: CP gathers no plane; TensorVM's
# density and appearance channel ranges each gather their 3 plane tables
OTHER_SCATTERS = {"TensorCP_MLP": 0, "TensorVM_SH": 6}


def _other(name, seed):
    cfg = OTHER_MODELS[name]
    params = FIELD_MODELS[cfg.model_name].init(jax.random.PRNGKey(seed), cfg, GRID)
    field = T_MODELS[cfg.model_name](TConfig(**dataclasses.asdict(cfg)), GRID, device="cpu")
    field.load_state_dict(params_from_jax(_flat(params)))
    return cfg, params, field


def _weights(cfg):
    # the loop's rule: the ortho weight applies to the VM models only
    return dict(WEIGHTS, ortho=WEIGHTS["ortho"] if "VM" in cfg.model_name else 0.0)


def _noise(key, n):
    k_strat, k_bg = jax.random.split(key)
    return (t(jax.random.uniform(k_strat, (n, 1), dtype=jnp.float32)),
            t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32)))


@pytest.mark.parametrize("name", list(OTHER_MODELS))
def test_one_step_gradients_match_jax_for_cp_and_vm(rng, name):
    cfg, params, field = _other(name, 4)
    rays, rgbs = _batch(rng, 64)
    key = jax.random.PRNGKey(12)
    weights = _weights(cfg)
    tx = _capture_grads()
    j_step = j_make_train_step(FIELD_MODELS[cfg.model_name], cfg,
                               JStatics(weights=JWeights(**weights), **STATICS), tx)
    _, opt_state, metrics = j_step(params, tx.init(params), None, jnp.asarray(AABB),
                                   jnp.asarray(rays), jnp.asarray(rgbs), jnp.asarray(3), key)
    j_grads = _flat(opt_state["g"])
    calls = []

    def counting(idx, g, n_rows):
        calls.append(g.shape[1])
        return scatter_add_reference(idx, g, n_rows)

    with mock.patch.object(grid_sample, "scatter_add", counting):
        total, t_metrics = loss_fn(field, TStatics(weights=TWeights(**weights), **STATICS),
                                   t(AABB), t(rays), t(rgbs), 3, *_noise(key, 64))
        total.backward()
    np.testing.assert_allclose(float(total.detach()), float(metrics["total_loss"]), rtol=1e-5,
                               atol=1e-6)
    assert ("reg_ortho" in t_metrics) == ("reg_ortho" in metrics) == (cfg.model_name == "TensorVM")
    grads = {n: p.grad for n, p in field.named_parameters()}
    assert set(grads) == set(j_grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[n], err_msg=n, **GRAD)
    assert len(calls) == OTHER_SCATTERS[name]


def test_loss_trajectory_follows_jax_for_cp_mlp(rng):
    """configs/lego.txt's TensorCP + MLP over 25 steps from the same params,
    batches and noise: the same loss curve (1e-3 relative per step)."""
    cfg, params, field = _other("TensorCP_MLP", 5)
    weights = _weights(cfg)
    statics = dict(STATICS, lr_factor=0.999)
    tx, state = j_make_optimizer(params, 0.02, 1e-3, 0.999)
    j_step = j_make_train_step(FIELD_MODELS["TensorCP"], cfg,
                               JStatics(weights=JWeights(**weights), **statics), tx)
    opt = make_optimizer(field, 0.02, 1e-3, 0.999)
    t_statics = TStatics(weights=TWeights(**weights), **statics)
    for it in range(25):
        rays, rgbs = _batch(rng, 64)
        key = jax.random.PRNGKey(200 + it)
        params, state, metrics = j_step(params, state, None, jnp.asarray(AABB), jnp.asarray(rays),
                                        jnp.asarray(rgbs), jnp.asarray(it), key)
        opt.zero_grad()
        total, _ = loss_fn(field, t_statics, t(AABB), t(rays), t(rgbs), it, *_noise(key, 64))
        total.backward()
        opt.step()
        np.testing.assert_allclose(float(total.detach()), float(metrics["total_loss"]), rtol=1e-3,
                                   err_msg=f"step {it}")


def test_make_train_step_updates_the_field(rng):
    params = JM.init(jax.random.PRNGKey(2), CFG, GRID)
    field = _field(params)
    before = {n: p.detach().clone() for n, p in field.named_parameters()}
    statics = TStatics(weights=TWeights(**WEIGHTS), **STATICS)
    step_fn = make_train_step(field, statics, make_optimizer(field, 0.02, 1e-3, 0.99))
    rays, rgbs = _batch(rng, 32)
    gen = torch.Generator().manual_seed(0)
    metrics = step_fn(t(AABB), t(rays), t(rgbs), 0, gen)
    assert np.isfinite(float(metrics["total_loss"]))
    assert all(not torch.equal(before[n], p) for n, p in field.named_parameters())


def test_simple_sampler_covers_the_store():
    s = SimpleSampler(10, 3, seed=1)
    seen = torch.cat([s.nextids() for _ in range(3)])
    assert len(set(seen.tolist())) == 9  # one permutation, no repeats
    assert SimpleSampler(2, 5, seed=1).nextids().shape == (5,)
    with pytest.raises(ValueError):
        SimpleSampler(0, 4)


def test_config_copy_parses_like_jax():
    paths = sorted(glob.glob("configs/*.txt"))
    assert "configs/flower.txt" in paths
    for path in paths:
        assert dataclasses.asdict(t_load_config(path)) == dataclasses.asdict(j_load_config(path))


def test_in_memory_scene_equals_jax_scene_on_disk(tmp_path):
    kw = dict(n_train=3, n_test=1, wh=(24, 20), scene="composite")
    make_synthetic_blender_scene(str(tmp_path), **kw)
    scene = make_synthetic_scene_arrays(**kw)
    for split in ("train", "test"):
        want = JBlender(str(tmp_path), split=split, wh=(24, 20), is_stack=True)
        from_disk = TBlender(str(tmp_path), split=split, wh=(24, 20), is_stack=True)
        in_memory = TBlender("unused", split=split, wh=(24, 20), is_stack=True, meta=scene[split])
        for got in (from_disk, in_memory):
            np.testing.assert_array_equal(got.all_rays, want.all_rays)
            np.testing.assert_array_equal(got.all_rgbs, want.all_rgbs)


def test_scene_views_trace_only_the_named_frames():
    """``views`` traces the frames it names, and only those of the splits
    it names: every camera and every traced image is the full scene's."""
    kw = dict(n_train=5, n_test=3, wh=(12, 12), scene="composite")
    full = make_synthetic_scene_arrays(**kw)
    some = make_synthetic_scene_arrays(**kw, views={"train": [0, 3]})
    for split in ("train", "test"):
        for k, (a, b) in enumerate(zip(full[split]["frames"], some[split]["frames"])):
            assert a["transform_matrix"] == b["transform_matrix"]
            if split == "test" or k in (0, 3):
                np.testing.assert_array_equal(a["image"], b["image"])
            else:
                assert not b["image"].any()


def test_train_steps_runs_end_to_end_on_cpu():
    small = dict(
        N_voxel_init=12**3, batch_size=128, n_lamb_sigma=[2, 2, 2], n_lamb_sh=[3, 3, 3],
        data_dim_color=6, featureC=16,
    )
    unported = dict(stratify=0, sample_budget=0, prefilter_budget=0)
    cfg = t_load_config("configs/synth_full.txt", {**small, **unported})
    scene = make_synthetic_scene_arrays(n_train=3, n_test=1, wh=(16, 16), scene="composite")
    logs = []
    res = train_steps(cfg, 3, device="cpu", scene=scene, log=logs.append)
    assert len(res.total_loss) == 3 and np.all(np.isfinite(res.total_loss))
    assert res.test_rgb.shape == (16, 16, 3) and np.isfinite(res.test_psnr)
    with pytest.raises(ValueError, match="first schedule segment"):
        train_steps(cfg, 2001, device="cpu", scene=scene, log=logs.append)
    # synth_full as written: stratified by in-bbox chord, budgets set
    as_written = t_load_config("configs/synth_full.txt", small)
    assert as_written.stratify and as_written.sample_budget and as_written.prefilter_budget
    logs.clear()
    res = train_steps(as_written, 3, device="cpu", scene=scene, log=logs.append)
    assert len(res.total_loss) == 3 and np.all(np.isfinite(res.total_loss))
    assert any("stratified ray store" in line for line in logs), logs
