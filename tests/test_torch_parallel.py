"""The port's ray-batch data parallelism (tensorf_tpu_torch/parallel) against
one rank and against tensorf_tpu/parallel, on the CPU over gloo.

Ranks are spawned processes (parallel/launch.py::spawn) that run the
torch-only rank functions of parallel/parity.py and meet at a file store
in a fresh temporary directory; every spawn has its own timeout.  The
parameters after a step are compared from an Adam state in progress (one
step taken, second moments 1e-6), where the update is a smooth function of
the gradient: from a fresh state Adam's first step is about lr * sign(g),
which float summation order flips on gradients near zero.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models import alpha_mask as jam
from tensorf_tpu.parallel import mesh as jmesh
from tensorf_tpu.render import culling as jcull
from tensorf_tpu.train import sampler as jsampler
from tensorf_tpu.train.losses import LossWeights as JWeights
from tensorf_tpu.train.optim import make_optimizer as j_make_optimizer
from tensorf_tpu.train.step import TrainStatics as JStatics
from tensorf_tpu.train.step import _multinomial_shares as j_shares
from tensorf_tpu.train.step import make_train_step as j_make_train_step
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import TensorVMSplit
from tensorf_tpu_torch.parallel import mesh as tmesh
from tensorf_tpu_torch.parallel import parity
from tensorf_tpu_torch.parallel.launch import RankFailed, join_from_env, rank_devices, spawn
from tensorf_tpu_torch.train import loop as tloop
from tensorf_tpu_torch.train import sampler as tsampler
from tensorf_tpu_torch.train import step as tstep
from tensorf_tpu_torch.train.losses import LossWeights as TWeights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = dict(rtol=1e-5, atol=1e-6)
# each launch's own bound: a hung rank fails its test, not the run
SPAWN = dict(timeout_s=120.0, collective_timeout_s=60.0)
CFG = ModelConfig(
    model_name="TensorVMSplit", density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6), app_dim=9,
    shading_mode="MLP_Fea", pos_pe=2, view_pe=2, fea_pe=2, feature_c=32, density_shift=-3.0,
)
GRID = (12, 12, 12)
AABB = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
JM = FIELD_MODELS["TensorVMSplit"]
# three strata: a budgeted one on a capped lattice, a budgeted one, an
# unbudgeted one; global quotas that divide by 2 and 4 ranks
QUOTAS = (24, 16, 8)
COMMON = dict(n_samples=128, step_size=0.05, white_bg=True, ndc_ray=False, total_steps=100,
              lr_factor=0.999, free_reg=True, free_decomp=True, freq_reg_ratio=0.8,
              shade_top_k=16, fused=True, strata_budgets=(48, 96, None),
              strata_alive_budgets=None, strata_n_samples=(64, 128, 128),
              strata_loss_weights=(0.5, 0.3, 0.2), strata_noise_match=True)
WEIGHTS = dict(ortho=0.01, l1=8e-5, tv_density=0.01, tv_app=0.01, occ=0.1, occ_range=5,
               occ_wb_range=12, occ_wb_prior=True)


def _flat(params):
    out = {}
    _flatten("", params, out)
    return out


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return np.concatenate([o, d], -1).astype(np.float32)


@pytest.fixture(scope="module")
def world_case():
    """The JAX params, a port field's state dict, a 35%-occupied mask, a
    256-ray store whose white and black rays fall unevenly on the shards,
    and per-stratum global ids."""
    params = JM.init(jax.random.PRNGKey(0), CFG, GRID)
    state = {k: v.numpy() for k, v in params_from_jax(
        {k.replace("/", "."): v for k, v in _flat(params).items()}).items()}
    vol = (np.random.default_rng(7).uniform(size=(10, 10, 10)) < 0.35).astype(np.float32)
    store = _rays(np.random.default_rng(5), 256)
    rgbs = np.random.default_rng(6).uniform(0.05, 0.95, size=(256, 3)).astype(np.float32)
    d = np.random.default_rng(8)
    ids = tuple(np.asarray(d.choice(256, size=n, replace=False), np.int32) for n in QUOTAS)
    # saturated ground truth on the first rays of each stratum's batch: the
    # occlusion prior's wider window then covers more rays on rank 0's shard
    for k, i in enumerate(ids):
        rgbs[i[: 3 + k]] = 1.0
        rgbs[i[-1]] = 0.0
    return params, state, vol, store, rgbs, ids


def _adam_in_progress(state):
    field = TensorVMSplit(TConfig(**dataclasses.asdict(CFG)), GRID, device="cpu")
    field.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return parity.adam_in_progress(field)


def _step_case(world_case, **over):
    _, state, vol, store, rgbs, ids = world_case
    case = dict(model_cfg=TConfig(**dataclasses.asdict(CFG)), grid=GRID, params=state,
                aabb=AABB, mask=(AABB, vol),
                statics=tstep.TrainStatics(weights=TWeights(**WEIGHTS), **COMMON),
                lr=(0.02, 1e-3, 1.0), opt_leaves=_adam_in_progress(state), rays=store,
                rgbs=rgbs, ids=ids, step=3, seed=11)
    case.update(over)
    return case


def _assert_same_params(got, want, tag):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{tag}: {k}", **PARAMS)


# ---- pools, strata, quotas, samplers ---------------------------------------------------


def test_host_ray_pool_matches_jax(monkeypatch):
    assert tmesh.host_ray_pool(100, 64, 0, 1) == jmesh.host_ray_pool(100, 64) == (None, 64)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    pools = []
    for p in range(4):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        jpool, jb = jmesh.host_ray_pool(100, 64)
        tpool, tb = tmesh.host_ray_pool(100, 64, p, 4)
        assert tb == jb == 16
        np.testing.assert_array_equal(tpool, jpool)
        pools.append(tpool)
    total = np.concatenate(pools)
    assert total.size == 100 and np.unique(total).size == 100
    for pool_fn in (lambda: jmesh.host_ray_pool(100, 63), lambda: tmesh.host_ray_pool(100, 63, 0, 4)):
        with pytest.raises(ValueError):
            pool_fn()


def test_pad_shard_and_host_reductions_on_one_rank():
    arr = np.arange(30, dtype=np.float32).reshape(10, 3)
    for a, b in zip(tmesh.pad_to_multiple(arr, 8), jmesh.pad_to_multiple(arr, 8)):
        np.testing.assert_array_equal(a, b)
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(torch.cat([tmesh.shard_rows(x, r, 3) for r in range(3)]), x)
    with pytest.raises(ValueError):
        tmesh.shard_rows(x, 0, 4)
    v = np.asarray([1, 2, 3], np.int64)
    np.testing.assert_array_equal(tmesh.host_allsum(v, None), v)
    np.testing.assert_array_equal(tmesh.host_allmax(v, None), v)


@pytest.mark.parametrize("seed", [3, 4])
def test_localize_strata_matches_jax(seed):
    rng = np.random.default_rng(seed)
    counts = np.concatenate([np.zeros(1500, np.int64), rng.integers(1, 40, 1600),
                             rng.integers(40, 97, 900)])
    rng.shuffle(counts)
    strata, budgets = jcull.stratify_rays(counts)
    for p in range(4):
        pool = tmesh.host_ray_pool(counts.size, 256, p, 4)[0]
        got = tsampler.localize_strata(strata, counts, pool, 96)
        want = jsampler.localize_strata(strata, counts, pool, 96)
        for g, w, b in zip(got, want, budgets):
            np.testing.assert_array_equal(g, w)
            assert np.all(np.isin(g, pool)) and counts[g].max() <= b
    # a pool that misses the upper strata borrows lower-count rays
    low = np.argsort(counts)[:50]
    for g, w in zip(tsampler.localize_strata(strata, counts, low, 96),
                    jsampler.localize_strata(strata, counts, low, 96)):
        np.testing.assert_array_equal(g, w)


def test_simple_sampler_pool_membership_and_coverage():
    pool = tmesh.host_ray_pool(100, 32, 1, 4)[0]
    for smp in (tsampler.SimpleSampler(100, 8, seed=3, pool=pool),
                jsampler.SimpleSampler(100, 8, seed=3, pool=pool)):
        seen = set()
        for _ in range(10):
            ids = np.asarray(smp.nextids())
            assert ids.shape == (8,) and np.all(np.isin(ids, pool))
            seen.update(ids.tolist())
        assert seen == set(pool.tolist())
    tiny = np.asarray([7, 11, 13], np.int64)
    ids = np.asarray(tsampler.SimpleSampler(100, 8, seed=0, pool=tiny).nextids())
    assert ids.shape == (8,) and np.all(np.isin(ids, tiny))
    with pytest.raises(ValueError, match="pool"):
        tsampler.SimpleSampler(100, 8, pool=np.zeros(0, np.int64))
    # the resume state carries the pool
    smp = tsampler.SimpleSampler(100, 8, seed=5, pool=pool)
    smp.nextids()
    meta, arrays = smp.get_state()
    again = tsampler.SimpleSampler(100, 8, seed=0, pool=np.arange(25))
    again.set_state(meta, arrays)
    assert torch.equal(again.nextids(), smp.nextids())


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_quota_rounding_matches_jax(n_dev):
    round_to = tloop.quota_round(n_dev)
    assert round_to == n_dev * -(-8 // n_dev) and round_to % n_dev == 0 and round_to >= 8
    batch = 4096 - 4096 % round_to
    for sizes in ([5000, 3000, 900, 40, 3], [100, 100], [7, 100000, 31, 2]):
        got = tsampler.allocate_quotas(sizes, batch, round_to)
        assert got == jsampler.allocate_quotas(sizes, batch, round_to)
        assert sum(got) == batch and all(q % n_dev == 0 for q in got)


# ---- one step on several ranks ---------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_step_on_ranks_matches_one_rank(world_case, world):
    """A stratified TensorVMSplit step (three strata, FreeNeRF masks, the
    occlusion prior with unequal white/black counts on the shards) on W gloo
    ranks, against one rank on the same global batch and noise."""
    _, _, _, _, rgbs, ids = world_case
    wb = np.all((rgbs > 0.99) | (rgbs < 0.01), axis=-1)
    shard_counts = [int(wb[tmesh.shard_rows(i, r, world)].sum()) for i in ids
                    for r in range(world)]
    assert len(set(shard_counts)) > 1, shard_counts
    case = _step_case(world_case)
    want = parity.one_step(None, "cpu", case)
    got = spawn(parity.one_step, (case,), ["cpu"] * world, **SPAWN)
    for r, res in enumerate(got):
        _assert_same_params(res["params"], want["params"], f"rank {r}")
        for k in ("mse", "total_loss", "reg_occ", "num_valid_samples", "stratum_overflow",
                  "budget_overflow_frac", "mean_alive_samples", "psnr"):
            np.testing.assert_allclose(res["metrics"][k], want["metrics"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        # a kept metric holds its own few bytes, not the flat gradient buffer
        assert res["metric_bytes"] <= 64, res["metric_bytes"]
        # each rank scatters as often as one rank, each time its share of rows
        assert res["launches"] == 0 and len(res["rows"]) == len(want["rows"])
        assert sum(res["rows"]) * world == sum(want["rows"])
    # after the all-reduce the ranks hold the same parameters bit for bit
    assert len({res["checksum"] for res in got}) == 1


def test_unstratified_step_on_ranks_matches_one_rank(world_case):
    _, _, _, store, _, _ = world_case
    statics = tstep.TrainStatics(weights=TWeights(**WEIGHTS),
                                 **dict(COMMON, strata_budgets=None, strata_n_samples=None,
                                        strata_loss_weights=None, sample_budget=64))
    case = _step_case(world_case, statics=statics,
                      ids=np.arange(0, 256, 4, dtype=np.int32))
    want = parity.one_step(None, "cpu", case)
    for r, res in enumerate(spawn(parity.one_step, (case,), ["cpu"] * 2, **SPAWN)):
        _assert_same_params(res["params"], want["params"], f"rank {r}")
        np.testing.assert_allclose(res["metrics"]["mse"], want["metrics"]["mse"], rtol=1e-5)


def _capture_adam_from(leaves, params):
    """JAX's optax state of the same Adam in progress."""
    _, fresh = j_make_optimizer(params, 0.02, 1e-3, 1.0)
    treedef = jax.tree_util.tree_structure(fresh)
    return treedef.unflatten([jnp.asarray(x) for x in leaves])


def test_two_ranks_match_jax_sharded_step(world_case):
    """The port's step on 2 gloo ranks against JAX's step with its batch
    sharded over make_mesh(2) (the conftest's virtual CPU devices), from
    the same parameters, Adam state, ids and noise."""
    params, state, vol, store, rgbs, ids = world_case
    case = _step_case(world_case)
    mesh = jmesh.make_mesh(2)
    jmask = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(AABB), volume=jnp.asarray(vol)))
    tx, _ = j_make_optimizer(params, 0.02, 1e-3, 1.0)
    opt_state = _capture_adam_from(case["opt_leaves"], params)
    j_step = j_make_train_step(JM, CFG, JStatics(weights=JWeights(**WEIGHTS), from_store=True,
                                                 **COMMON), tx)
    key = jax.random.PRNGKey(11)
    j_params, _, j_metrics = j_step(
        jmesh.replicate(mesh, params), jmesh.replicate(mesh, opt_state), jmask,
        jnp.asarray(AABB), jnp.asarray(store), jnp.asarray(rgbs),
        tuple(jmesh.shard_rays(mesh, jnp.asarray(i)) for i in ids), jnp.asarray(3, jnp.int32),
        key)
    # the JAX step's global draws (tensorf_tpu/train/step.py:213-220)
    key, key_comp = jax.random.split(key)
    statics = case["statics"]
    shares = np.asarray(jnp.stack(j_shares(key_comp, float(sum(QUOTAS)), tuple(
        tstep.strata_loss_shares(statics, list(QUOTAS))))))
    us, flips = [], []
    for k, ids_s in zip(jax.random.split(key, len(ids)), ids):
        k_strat, k_bg = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(k_strat, (len(ids_s), 1), dtype=jnp.float32)))
        flips.append(np.asarray((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32)))
    case["noise"] = (us, flips, shares)
    got = spawn(parity.one_step, (case,), ["cpu"] * 2, **SPAWN)
    want = {k.replace("/", "."): np.asarray(v) for k, v in _flat(jax.device_get(j_params)).items()}
    for r, res in enumerate(got):
        _assert_same_params(res["params"], want, f"rank {r} vs JAX")
        np.testing.assert_allclose(res["metrics"]["mse"], float(j_metrics["mse"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["metrics"]["total_loss"], float(j_metrics["total_loss"]),
                                   rtol=1e-5, atol=1e-6)


# ---- serving -----------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["stratified", "legacy", "uniform"])
def test_sharded_serving_matches_one_rank(world_case, mode):
    _, state, vol, _, _, _ = world_case
    rays = _rays(np.random.default_rng(9), 300)
    handle = dict(step_size=0.05, n_samples=128, white_bg=True, ndc_ray=False, shade_top_k=16,
                  stratified=mode != "uniform", use_coarse_gate=mode != "legacy",
                  sample_budget=96 if mode == "uniform" else None)
    case = dict(model_cfg=TConfig(**dataclasses.asdict(CFG)), grid=GRID, params=state,
                aabb=AABB, mask=(AABB, vol), rays=rays, chunk=64, handle=handle)
    want = parity.serve(None, "cpu", case)
    for res in spawn(parity.serve, (case,), ["cpu"] * 3, **SPAWN):
        np.testing.assert_allclose(res["rgb"], want["rgb"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["depth"], want["depth"], rtol=1e-4, atol=1e-4)
        assert res["n_valid"] == want["n_valid"] and res["overflow"] == want["overflow"]


# ---- the launch: resume agreement, failures, the CLI -----------------------------------


def test_resume_disagreement_starts_every_rank_fresh():
    agree = [("a/1k.npz", 1000), ("a/1k.npz", 1000)]
    cases = [agree, [("a/1k.npz", 1000), ("a/2k.npz", 2000)], [("a/1k.npz", 1000), None],
             [None, None]]
    for rank in spawn(parity.agreed_resume, (cases,), ["cpu"] * 2, **SPAWN):
        assert rank == [agree[0], None, None, None]


@pytest.mark.parametrize("how,code", [("raise", 1), ("wedge", 17)])
def test_failing_rank_fails_the_launch(how, code):
    t0 = time.perf_counter()
    with pytest.raises(RankFailed) as err:
        spawn(parity.fail_on_rank, (1, how), ["cpu"] * 3, timeout_s=60.0,
              collective_timeout_s=30.0)
    assert err.value.exitcode == code
    assert time.perf_counter() - t0 < 40.0


def test_options_that_cannot_hold_raise(monkeypatch):
    assert len(rank_devices(0, "cpu")) == 1 and len(rank_devices(3, "cpu")) == 3
    monkeypatch.setenv("TFTPU_COORDINATOR", "localhost:1")
    monkeypatch.setenv("TFTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("TFTPU_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="n_devices 3"):
        join_from_env(3, "cpu")
    from tensorf_tpu_torch.config import TrainConfig

    with pytest.raises(ValueError, match="one device"):
        tloop.train_steps(TrainConfig(n_devices=2), 1, device="cpu")


TINY = ["--config", "configs/synth_sphere.txt", "--device", "cpu", "--synthetic",
        "--synthetic_scene", "sphere", "--synthetic_wh", "40", "--synthetic_views", "4,1",
        "--downsample_train", "1", "--n_iters", "10", "--N_voxel_init", "1000",
        "--N_voxel_final", "4096", "--upsamp_list", "[3,6]", "--update_AlphaMask_list", "[4,7]",
        "--vis_every", "5", "--save_ckpt_every", "[5]", "--batch_size", "256",
        "--save_images", "0"]


def _cli(basedir, n_devices):
    proc = subprocess.run([sys.executable, "-m", "tensorf_tpu_torch", *TINY, "--basedir",
                           str(basedir), "--n_devices", str(n_devices)],
                          cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stdout


def test_tiny_cli_run_on_two_ranks(tmp_path):
    """The tiny sphere command through two upsamples and two alpha masks on
    --n_devices 2 against --n_devices 1."""
    one, _ = _cli(tmp_path / "one", 1)
    two, out = _cli(tmp_path / "two", 2)
    # rank 0 alone writes: the same files as one rank's run, one event file
    files = {os.path.relpath(p, tmp_path / "two") for p in glob.glob(str(tmp_path / "two/**/*"),
                                                                     recursive=True)}
    want = {os.path.relpath(p, tmp_path / "one") for p in glob.glob(str(tmp_path / "one/**/*"),
                                                                    recursive=True)}
    strip = lambda fs: {f for f in fs if "tfevents" not in f}  # noqa: E731 - host-named
    assert strip(files) == strip(want)
    assert sum("tfevents" in f for f in files) == sum("tfevents" in f for f in want) <= 1
    digests = [line.rsplit(" ", 1)[-1] for line in out.splitlines()
               if "parameter digest" in line]
    assert len(digests) == 2 and digests[0] == digests[1], digests
    assert "rank 1 of 2 (gloo" in out
    assert abs(two["final_test_psnr"] - one["final_test_psnr"]) < 0.75


def test_pooled_ranks_run_the_schedule(tmp_path):
    """The distributed layout (each rank its own id pool, seed and slice of
    the global plan) through the tiny schedule on two gloo ranks: the same
    plans and parameters on both, the PSNR of one rank's run within 0.75
    dB."""
    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays

    over = dict(n_iters=10, N_voxel_init=1000, N_voxel_final=4096, upsamp_list=[3, 6],
                update_AlphaMask_list=[4, 7], vis_every=5, batch_size=256,
                downsample_train=1.0, progress_refresh_rate=2)
    scene = make_synthetic_scene_arrays(n_train=4, n_test=1, wh=(40, 40), scene="sphere")
    one = parity.reconstruct(None, "cpu", load_config(
        "configs/synth_sphere.txt", dict(over, basedir=str(tmp_path / "one"))), scene)
    cfg = load_config("configs/synth_sphere.txt", dict(over, basedir=str(tmp_path / "two")))
    got = spawn(parity.reconstruct, (cfg, scene, True), ["cpu"] * 2, **SPAWN)
    plans = [[m for m in res["lines"] if "stratified ray store" in m or "'event'" in m]
             for res in got]
    assert plans[0] == plans[1] and len(plans[0]) >= 6
    assert got[0]["checksums"] == got[1]["checksums"]
    assert got[0]["final_checksum"] == got[1]["final_checksum"]
    assert any("own id pool" in m for m in got[1]["lines"])
    psnr = [float(np.mean(res["result"].final_psnrs)) for res in (one, *got)]
    assert psnr[1] == psnr[2] and abs(psnr[1] - psnr[0]) < 0.75, psnr



# a launch whose two ranks print LINES lines each, each line at the same
# moment on both (a barrier before it), then return and are killed right
# after their report: as spawn kills a rank still exiting when its join
# times out, before the rank's own exit would flush its stdout
LINES = 200
RANK_LINES = """
import multiprocessing.util, os, signal
import torch.distributed as dist
from tensorf_tpu_torch.parallel.launch import spawn


def print_lines(group, device, n):
    for i in range(n):
        dist.barrier()
        print(f"[port] rank {group.rank} of {group.world}: line {i} of the same length")
    # after the results queue's feeder (-5) has sent the report
    multiprocessing.util.Finalize(None, os.kill, (os.getpid(), signal.SIGKILL), exitpriority=-10)


if __name__ == "__main__":
    spawn(print_lines, (%d,), ["cpu", "cpu"], timeout_s=60.0, collective_timeout_s=30.0)
""" % LINES


@pytest.mark.parametrize("unbuffered", [0, 1])
def test_rank_lines_reach_a_shared_pipe_whole(tmp_path, unbuffered):
    """Every line both ranks print reaches the launch's stdout, a pipe,
    whole: block-buffered, though each rank dies right after its report;
    unbuffered (PYTHONUNBUFFERED), though print writes a line's text and
    its newline apart and the two ranks print at the same moment."""
    script = tmp_path / "ranks.py"
    script.write_text(RANK_LINES)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONUNBUFFERED"}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, *filter(None, [env.get("PYTHONPATH")])])
    if unbuffered:
        env["PYTHONUNBUFFERED"] = "1"
    proc = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = sorted(line for line in proc.stdout.splitlines() if line)
    want = sorted(f"[port] rank {r} of 2: line {i} of the same length"
                  for r in range(2) for i in range(LINES))
    assert lines == want, [line for line in lines if line not in want][:5]
