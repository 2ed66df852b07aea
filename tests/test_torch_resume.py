"""Resume, the watchdog and the supervisor in the port, against tensorf_tpu.

Ports of tests/test_resume_and_gate.py's watchdog, mid-run resume,
supervisor, prior-date logfolder, sampler-state and bit-exact resume tests
to tensorf_tpu_torch, on 24x24 scenes at small widths.  A resumable
checkpoint crosses between the packages both ways with its Adam state;
one Adam update from the same carried state and the same injected jitter
gives parameters within 1e-5 (rtol and atol) in both packages.  The port's
killed-and-resumed run equals its clean run exactly (torch.equal).
"""

import dataclasses
import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.config.schema import TrainConfig as JConfig
from tensorf_tpu.data import dataset_dict as j_datasets
from tensorf_tpu.data.synthetic import make_synthetic_blender_scene
from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.train import LossWeights as JWeights
from tensorf_tpu.train import TrainStatics as JStatics
from tensorf_tpu.train import loop as jloop
from tensorf_tpu.train import make_optimizer as j_make_optimizer
from tensorf_tpu.train import make_train_step as j_make_train_step
from tensorf_tpu.utils import ckpt as jckpt
from tensorf_tpu_torch import __main__ as cli
from tensorf_tpu_torch.config import TrainConfig
from tensorf_tpu_torch.convert import optimizer_from_jax, optimizer_to_jax, params_from_jax
from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import FIELD_MODELS as T_MODELS
from tensorf_tpu_torch.models import TensorVMSplit
from tensorf_tpu_torch.train import LossWeights as TWeights
from tensorf_tpu_torch.train import TrainStatics as TStatics
from tensorf_tpu_torch.train import loop as tloop
from tensorf_tpu_torch.train import loss_fn, make_optimizer
from tensorf_tpu_torch.train.sampler import SimpleSampler, StratifiedSampler
from tensorf_tpu_torch.utils import ckpt as tckpt
from tensorf_tpu_torch.utils.watchdog import EXIT_WEDGED, Watchdog

WH = (24, 24)
# the JAX resume tests' run (test_resume_and_gate.py:174-200): upsample at
# 20, masks at 22 (shrink) and 28 (re-filter), a checkpoint at 30
COMMON = dict(
    dataset_name="blender", model_name="TensorVMSplit", shadingMode="MLP_Fea", batch_size=256,
    N_voxel_init=16**3, N_voxel_final=20**3, upsamp_list=[20], update_AlphaMask_list=[22, 28],
    save_ckpt_every=[30], n_lamb_sigma=[2, 2, 2], n_lamb_sh=[2, 2, 2], data_dim_color=6,
    featureC=16, pos_pe=2, view_pe=2, fea_pe=2, density_shift=-3.0, vis_every=1000,
    train_vis_every=1000, render_test=0, progress_refresh_rate=100, n_devices=1,
)


class Killed(Exception):
    pass


def kill_at(iteration):
    """on_step that dies after step ``iteration`` (its checkpoint not yet
    written), as a wedge would."""
    def on_step(it, state):
        if it == iteration:
            raise Killed()
    return on_step


def scene_arrays():
    return make_synthetic_scene_arrays(n_train=4, n_test=1, wh=WH, scene="composite")


def port_cfg(tmp_path, **over):
    return TrainConfig(**dict(COMMON, basedir=str(tmp_path / "log"), **over))


def run(cfg, scene, **kw):
    return tloop.reconstruction(cfg, scene, "cpu", save_images=False, **kw)


def test_watchdog_fires_and_respects_beats_and_build_writes(tmp_path):
    """Fires after the timeout with no beats, not while beats arrive, and
    counts recent writes under the build directory as progress."""
    fired = []
    wd = Watchdog(0.3, on_stall=fired.append, poll_s=0.05).start()
    time.sleep(0.8)
    wd.stop()
    assert fired and fired[0] > 0.3

    fired.clear()
    wd = Watchdog(0.3, on_stall=fired.append, poll_s=0.05).start()
    for _ in range(10):
        wd.beat()
        time.sleep(0.1)
    wd.stop()
    assert not fired

    fired.clear()
    build = tmp_path / "build"
    build.mkdir()
    wd = Watchdog(0.4, on_stall=fired.append, poll_s=0.05, cache_dirs=[str(build)]).start()
    for i in range(8):  # a ~0.8 s stall, covered by the build's writes
        (build / f"lib{i}.so.tmp").write_text("x")
        time.sleep(0.1)
    assert not fired
    time.sleep(0.9)  # now both the beat and the writes are stale
    wd.stop()
    assert fired

    wd = Watchdog(0.0, on_stall=fired.append).start()  # 0 disables it
    assert wd._thread is None
    wd.stop()


def test_resume_continues_mid_run(tmp_path, capsys):
    """--resume 1 continues a killed run from its newest resumable
    checkpoint: iteration, optimizer state, schedule position and the
    alpha-filtered ray store restored, no event fires again; a finished
    run's resume only finalizes."""
    scene = scene_arrays()
    logs = []
    with pytest.raises(Killed):
        run(port_cfg(tmp_path, n_iters=45), scene, log=logs.append, on_step=kill_at(31))
    (folder,) = (tmp_path / "log").glob("*/exp")
    assert tckpt.load_opt_leaves(str(folder / "0k_exp.npz")) is not None
    capsys.readouterr()
    logs.clear()
    res = run(port_cfg(tmp_path, n_iters=45, resume=1), scene, log=logs.append)
    out = "\n".join(logs) + capsys.readouterr().out
    assert "[resume] continuing at iteration 31" in out
    assert "[resume] optimizer state restored" in out
    assert "[resume] sampling state restored" in out
    assert "[resume] store re-filtered" in out  # past both mask events
    assert not res.events  # no schedule event fires again
    assert len(res.total_loss) == 45 - 31
    _, field, _, grid, mask, extra = tckpt.load_checkpoint(res.final_path, "cpu")
    assert grid == (20, 20, 20) and mask is not None and extra["iteration"] == 44

    logs.clear()
    res = run(port_cfg(tmp_path, n_iters=45, resume=1), scene, log=logs.append)
    assert any("continuing at iteration 45" in line for line in logs)
    assert not any(line.startswith("Iteration") for line in logs)  # no step ran
    assert not res.total_loss and not res.plans  # no count pass, no step built


def test_supervisor_relaunches_on_wedged_exit(monkeypatch):
    """--auto_resume N relaunches `python -m tensorf_tpu_torch` with
    --resume 1 while the child exits EXIT_WEDGED, stops on success, and
    gives up after N relaunches."""
    calls = []

    def fake_call(cmd):
        calls.append(cmd)
        return EXIT_WEDGED if len(calls) <= 2 else 0

    monkeypatch.setattr("subprocess.call", fake_call)
    assert cli._supervise(["--config", "x.txt"], retries=3) == 0 and len(calls) == 3
    assert calls[0][1:3] == ["-m", "tensorf_tpu_torch"]
    assert "--resume" not in calls[0] and "--resume" in calls[1]
    for c in calls:  # the child never supervises again
        assert c[c.index("--auto_resume") + 1] == "0"

    calls.clear()
    monkeypatch.setattr("subprocess.call", lambda cmd: calls.append(cmd) or EXIT_WEDGED)
    assert cli._supervise(["--config", "x.txt"], retries=2) == EXIT_WEDGED
    assert len(calls) == 3  # the first launch and 2 relaunches
    calls.clear()
    assert cli.main(["--config", "configs/synth_sphere.txt", "--auto_resume", "1"]) == EXIT_WEDGED
    assert len(calls) == 2


def test_resume_finds_prior_date_logfolder(tmp_path):
    """A resume relaunched after local midnight continues in the newest
    prior date folder of the expname, as the JAX loop's does."""
    base = tmp_path / "log"
    prior = base / "2020-01-01" / "exp"
    prior.mkdir(parents=True)
    (prior / "0k_exp.npz").write_bytes(b"x")
    cfg = TrainConfig(basedir=str(base), expname="exp", resume=1)
    assert tloop._make_logfolder(cfg) == str(prior) == jloop._make_logfolder(
        JConfig(basedir=str(base), expname="exp", resume=1))
    assert tloop._make_logfolder(dataclasses.replace(cfg, resume=0)) != str(prior)


def test_resume_with_overwrt_keeps_the_folder(tmp_path):
    """overwrt empties the logfolder of a fresh run, never of a resume."""
    cfg = TrainConfig(basedir=str(tmp_path), expname="exp", overwrt=True, resume=1)
    folder = tloop._make_logfolder(cfg)
    for sub in ("imgs_vis", "imgs_rgba", "rgba"):
        assert os.path.isdir(os.path.join(folder, sub))
    keep = os.path.join(folder, "0k_exp.npz")
    open(keep, "wb").close()
    assert tloop._make_logfolder(cfg) == folder and os.path.exists(keep)
    tloop._make_logfolder(dataclasses.replace(cfg, resume=0))
    assert not os.path.exists(keep)


def test_sampler_state_roundtrip():
    """get_state/set_state continue the id stream exactly, for both
    samplers, across epoch reshuffles."""
    a = SimpleSampler(1000, 64, seed=7)
    for _ in range(5):
        a.nextids()
    meta, arrays = a.get_state()
    b = SimpleSampler(1000, 64, seed=999)  # another seed on purpose
    b.set_state(meta, arrays)
    for _ in range(30):
        assert torch.equal(a.nextids(), b.nextids())
    with pytest.raises(ValueError, match="mismatch"):
        SimpleSampler(999, 64).set_state(meta, arrays)

    strata = [np.arange(0, 300), np.arange(300, 900), np.arange(900, 1000)]
    sa = StratifiedSampler(strata, [32, 24, 8], seed=3)
    for _ in range(4):
        sa.nextids()
    sb = StratifiedSampler.from_state(*sa.get_state())
    for _ in range(40):
        for x, y in zip(sa.nextids(), sb.nextids()):
            assert torch.equal(x, y)


def test_resume_is_bit_exact(tmp_path):
    """A run killed after step 31 and resumed from its checkpoint at 30
    ends in the clean run's state exactly: every parameter, the mask, the
    aabb and history.npz (rows 10..30 written before the kill)."""
    scene = scene_arrays()
    cfg = port_cfg(tmp_path, n_iters=45, train_vis_every=10)
    clean = run(dataclasses.replace(cfg, expname="clean"), scene, log=lambda m: None)
    with pytest.raises(Killed):
        run(dataclasses.replace(cfg, expname="resumed"), scene, log=lambda m: None,
            on_step=kill_at(31))
    logs = []
    resumed = run(dataclasses.replace(cfg, expname="resumed", resume=1), scene, log=logs.append)
    assert any("continuing at iteration 31" in line for line in logs)
    assert any("sampling state restored (stratified)" in line for line in logs)
    assert clean.total_loss[31:] == resumed.total_loss
    a, b = clean.state, resumed.state
    assert a.geometry == b.geometry
    for (name, p), (_, q) in zip(a.field.named_parameters(), b.field.named_parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(a.alpha_mask.volume, b.alpha_mask.volume)
    for x, y in zip(optimizer_to_jax(a.optimizer, a.field), optimizer_to_jax(b.optimizer, b.field)):
        np.testing.assert_array_equal(x, y)
    ha = np.load(os.path.join(os.path.dirname(clean.final_path), "history.npz"))
    hb = np.load(os.path.join(os.path.dirname(resumed.final_path), "history.npz"))
    assert list(hb["iteration"]) == [10, 20, 30, 40] and sorted(ha.files) == sorted(hb.files)
    for k in ha.files:
        np.testing.assert_array_equal(ha[k], hb[k])


def test_resume_of_a_copied_logfolder_is_bit_exact(tmp_path, monkeypatch):
    """chip_smoke's resume phase: a copy of the running run's logfolder
    after step 31 (``resume_snapshot``) is what a kill there leaves, and
    resuming the copy ends in that run's state exactly."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "RESUME_KILL", 31)
    scene = scene_arrays()
    cfg = port_cfg(tmp_path, n_iters=45, train_vis_every=10)
    copy = str(tmp_path / "copy")
    clean = run(cfg, scene, log=lambda m: None, on_step=chip_smoke.resume_snapshot(cfg, copy))
    logs = []
    resumed = run(dataclasses.replace(cfg, basedir=copy, resume=1), scene, log=logs.append)
    assert any("continuing at iteration 31" in line for line in logs)
    assert any("sampling state restored (stratified)" in line for line in logs)
    assert clean.total_loss[31:] == resumed.total_loss
    for (name, p), (_, q) in zip(clean.state.field.named_parameters(),
                                 resumed.state.field.named_parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(clean.state.alpha_mask.volume, resumed.state.alpha_mask.volume)


# ---- crossing between the packages ---------------------------------------------

def _jax_run(tmp_path, **over):
    """JAX's reconstruction on the same scene, from disk."""
    datadir = str(tmp_path / "scene")
    if not os.path.exists(datadir):
        make_synthetic_blender_scene(datadir, n_train=4, n_test=1, wh=WH, scene="composite")
    orig = j_datasets["blender"]
    j_datasets["blender"] = partial(orig, wh=WH)
    try:
        return jloop.reconstruction(JConfig(**dict(COMMON, basedir=str(tmp_path / "log"),
                                                   datadir=datadir, **over)))
    finally:
        j_datasets["blender"] = orig


def test_resumable_checkpoints_cross_both_ways(tmp_path, capsys):
    """The port resumes a JAX-written resumable checkpoint with the Adam
    moments, counts and LR position of its opt/ leaves (restratifying: the
    JAX sampler state is numpy's); JAX resumes a port-written one and
    restores its optimizer state, and re-saves the same leaves."""
    over = dict(n_iters=8, upsamp_list=[3], update_AlphaMask_list=[4], save_ckpt_every=[5],
                expname="jax_run")
    jax_final = _jax_run(tmp_path, **over)
    jax_leaves = jckpt.load_opt_leaves(jax_final)
    assert int(jax_leaves[0]) == 3  # Adam steps since the reset at the last event (4): 5, 6, 7
    scene = scene_arrays()
    cfg = port_cfg(tmp_path, **dict(over, n_iters=10, resume=1))
    state = tloop.TrainState(dataclasses.replace(cfg, ckpt_path=jax_final),
                             torch.device("cpu"), scene)
    assert state.start_iter == 8 and state.resume_extra is not None
    assert state.restore_optimizer(jckpt.load_opt_leaves(jax_final), log=lambda m: None)
    got = optimizer_to_jax(state.optimizer, state.field)
    assert len(got) == len(jax_leaves)
    for x, y in zip(got, jax_leaves):
        assert x.dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, np.asarray(y))
    lr = state.optimizer.adam.param_groups[0]["lr"]
    np.testing.assert_allclose(lr, cfg.lr_init * state.lr_factor ** 3, rtol=1e-12)

    logs = []
    res = run(cfg, scene, log=logs.append)  # the port continues the JAX run: 8, 9
    assert any("continuing at iteration 8" in line for line in logs)
    assert any("optimizer state restored" in line for line in logs)
    assert any("sampling-state restore failed" in line and "restratifying" in line
               for line in logs)
    assert len(res.total_loss) == 2 and np.all(np.isfinite(res.total_loss))

    # JAX resumes the port's final checkpoint (a finished run: it restores
    # the optimizer, re-saves the checkpoint and trains nothing)
    port_leaves = tckpt.load_opt_leaves(res.final_path)
    capsys.readouterr()
    again = _jax_run(tmp_path, **dict(over, n_iters=10, resume=1))
    out = capsys.readouterr().out
    assert again == res.final_path
    assert "[resume] continuing at iteration 10" in out
    assert "[resume] optimizer state restored" in out and "mismatch" not in out
    for x, y in zip(jckpt.load_opt_leaves(again), port_leaves):
        np.testing.assert_array_equal(np.asarray(x), y)


CFG = ModelConfig(model_name="TensorVMSplit", density_n_comp=(2, 3, 4), app_n_comp=(4, 3, 2),
                  app_dim=6, shading_mode="MLP_Fea", pos_pe=2, view_pe=2, fea_pe=2, feature_c=16,
                  density_shift=-3.0)
AABB = np.asarray([[-1.5] * 3, [1.5] * 3], np.float32)
STATICS = dict(n_samples=64, step_size=0.08, white_bg=True, ndc_ray=False, total_steps=100,
               lr_factor=0.99, free_reg=True, free_decomp=True, freq_reg_ratio=0.8)
WEIGHTS = dict(ortho=0.01, l1=8e-5, tv_density=0.01, tv_app=0.01)


def test_adam_update_from_carried_state_matches_jax(rng):
    """Carry a JAX Adam state three updates in, load its leaves into the
    port's optimizer, and take one train step in each package with the
    same batch and jitter: the parameters and the moments agree within
    1e-5 (rtol and atol), and the counts and LR position exactly."""
    JM = FIELD_MODELS["TensorVMSplit"]
    params = JM.init(jax.random.PRNGKey(4), CFG, (16, 16, 16))
    tx, opt_state = j_make_optimizer(params, 0.02, 1e-3, 0.99)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(scale=1e-2, size=p.shape), jnp.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    flat = {}
    jckpt._flatten("", params, flat)
    field = TensorVMSplit(TConfig(**dataclasses.asdict(CFG)), (16, 16, 16), device="cpu")
    field.load_state_dict(params_from_jax(flat))
    opt = make_optimizer(field, 0.02, 1e-3, 0.99)
    optimizer_from_jax(opt, field, jax.tree_util.tree_leaves(opt_state))
    assert opt.schedule_count == 3

    o = rng.normal(size=(64, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(64, 3))
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rgbs = rng.uniform(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    j_step = j_make_train_step(JM, CFG, JStatics(weights=JWeights(**WEIGHTS), **STATICS), tx)
    params, opt_state, _ = j_step(params, opt_state, None, jnp.asarray(AABB), jnp.asarray(rays),
                                  jnp.asarray(rgbs), jnp.asarray(3), key)
    k_strat, k_bg = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(k_strat, (64, 1), dtype=jnp.float32)))
    flip = torch.tensor(float(jax.random.uniform(k_bg, ()) < 0.5))
    opt.zero_grad()
    total, _ = loss_fn(field, TStatics(weights=TWeights(**WEIGHTS), **STATICS),
                       torch.from_numpy(AABB), torch.from_numpy(rays), torch.from_numpy(rgbs), 3,
                       u, flip)
    total.backward()
    opt.step()
    flat = {}
    jckpt._flatten("", params, flat)
    for name, p in field.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[name.replace(".", "/")], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for x, y in zip(optimizer_to_jax(opt, field), jax.tree_util.tree_leaves(opt_state)):
        if x.ndim == 0:
            assert int(x) == int(y) == 4
        else:
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-5)


# TensorCP with an MLP head (configs/lego.txt's) and TensorVM with SH: their
# Adam state in the optax layout (sorted keys: CP app_line, basis,
# density_line, render; VM basis, line, plane) and one step from it
OTHER = {
    "TensorCP_MLP": dataclasses.replace(CFG, model_name="TensorCP", density_n_comp=(3,),
                                        app_n_comp=(4,), shading_mode="MLP"),
    "TensorVM_SH": dataclasses.replace(CFG, model_name="TensorVM", density_n_comp=(3,),
                                       app_n_comp=(2,), app_dim=27, shading_mode="SH"),
}


@pytest.mark.parametrize("name", list(OTHER))
def test_cp_and_vm_adam_state_crosses_by_value(rng, tmp_path, name):
    cfg = OTHER[name]
    JM = FIELD_MODELS[cfg.model_name]
    grid = (12, 13, 14)
    params = JM.init(jax.random.PRNGKey(5), cfg, grid)
    tx, opt_state = j_make_optimizer(params, 0.02, 1e-3, 0.99)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(scale=1e-2, size=p.shape), jnp.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    flat = {}
    jckpt._flatten("", params, flat)
    field = T_MODELS[cfg.model_name](TConfig(**dataclasses.asdict(cfg)), grid, device="cpu")
    field.load_state_dict(params_from_jax(flat))
    opt = make_optimizer(field, 0.02, 1e-3, 0.99)
    leaves = jax.tree_util.tree_leaves(opt_state)
    optimizer_from_jax(opt, field, leaves)
    # back out by value, leaf for leaf, in the optax order
    back = optimizer_to_jax(opt, field)
    assert [np.shape(x) for x in back] == [np.shape(y) for y in leaves]
    for x, y in zip(back, leaves):
        np.testing.assert_array_equal(x, np.asarray(y))
    # a resumable port checkpoint's leaves rebuild the optax state in JAX
    path = tckpt.save_checkpoint(str(tmp_path / "r"), field, AABB, opt_leaves=back,
                                 extra={"iteration": 3})
    rebuilt = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(opt_state),
                                           [jnp.asarray(x) for x in jckpt.load_opt_leaves(path)])
    for x, y in zip(jax.tree_util.tree_leaves(rebuilt), leaves):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    # one step from the carried state in each package
    o = rng.normal(size=(64, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(64, 3))
    rays = np.concatenate([o, d], -1).astype(np.float32)
    rgbs = rng.uniform(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    weights = dict(WEIGHTS, ortho=WEIGHTS["ortho"] if "VM" in cfg.model_name else 0.0)
    j_step = j_make_train_step(JM, cfg, JStatics(weights=JWeights(**weights), **STATICS), tx)
    params, opt_state, _ = j_step(params, opt_state, None, jnp.asarray(AABB), jnp.asarray(rays),
                                  jnp.asarray(rgbs), jnp.asarray(3), key)
    k_strat, k_bg = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(k_strat, (64, 1), dtype=jnp.float32)))
    flip = torch.tensor(float(jax.random.uniform(k_bg, ()) < 0.5))
    opt.zero_grad()
    total, _ = loss_fn(field, TStatics(weights=TWeights(**weights), **STATICS),
                       torch.from_numpy(AABB), torch.from_numpy(rays), torch.from_numpy(rgbs), 3,
                       u, flip)
    total.backward()
    opt.step()
    flat = {}
    jckpt._flatten("", params, flat)
    for n, p in field.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[n.replace(".", "/")], rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    for x, y in zip(optimizer_to_jax(opt, field), jax.tree_util.tree_leaves(opt_state)):
        if x.ndim == 0:
            assert int(x) == int(y) == 4
        else:
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-5)
