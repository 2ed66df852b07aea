"""Parity of the port's sample budgets and ray stratification with tensorf_tpu's.

The same seeded numpy inputs go through both packages at the sizes of
tests/test_stratified.py (grid 12^3, 128 samples, a 35%-occupied 10^3
mask): the coarse pre-gate (exact), every budget mode of render_rays
(rgb 1e-5, depth 1e-4, overflow and alive means equal, the selected
lattice indices equal index for index), the count passes (exact), the
numpy strata plan, the samplers, the loop's restratify and auto-raise
against the JAX loop's own composition, and one stratified step's
gradients against ``jax.value_and_grad`` (rtol/atol 1e-4).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorf_tpu.models import FIELD_MODELS, ModelConfig
from tensorf_tpu.models import alpha_mask as jam
from tensorf_tpu.ops.freq_mask import FreeMasks as JMasks
from tensorf_tpu.render import culling as jcull
from tensorf_tpu.render import render_rays as j_render
from tensorf_tpu.train import sampler as jsampler
from tensorf_tpu.train.losses import LossWeights as JWeights
from tensorf_tpu.train.step import TrainStatics as JStatics
from tensorf_tpu.train.step import _multinomial_shares as j_shares
from tensorf_tpu.train.step import make_train_step as j_make_train_step
from tensorf_tpu.utils.ckpt import _flatten
from tensorf_tpu_torch.config import load_config
from tensorf_tpu_torch.convert import params_from_jax
from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
from tensorf_tpu_torch.models import ModelConfig as TConfig
from tensorf_tpu_torch.models import TensorVMSplit
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.ops import grid_sample
from tensorf_tpu_torch.ops.freq_mask import FreeMasks as TMasks
from tensorf_tpu_torch.ops.rays import sample_lattice
from tensorf_tpu_torch.ops.scatter_add import scatter_add_reference
from tensorf_tpu_torch.render import culling as tcull
from tensorf_tpu_torch.render import volume as tvolume
from tensorf_tpu_torch.train import loop as tloop
from tensorf_tpu_torch.train import sampler as tsampler
from tensorf_tpu_torch.train import step as tstep
from tensorf_tpu_torch.train.losses import LossWeights as TWeights

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
GRAD = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def _rays(rng, n):
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.1 * rng.normal(size=(n, 3))
    return np.concatenate([o, d], -1).astype(np.float32)


def _flat(params):
    out = {}
    _flatten("", params, out)
    return out


def both_masks(vol, aabb=AABB):
    j = jam.with_dilation(jam.AlphaGridMask(aabb=jnp.asarray(aabb), volume=jnp.asarray(vol)))
    p = tam.with_dilation(tam.AlphaGridMask(aabb=t(aabb), volume=t(vol)))
    return j, p


@torch.no_grad()
def _render(*args, **kw):
    return tvolume.render_rays(*args, **kw)


@pytest.fixture(scope="module")
def setup():
    params = JM.init(jax.random.PRNGKey(0), CFG, GRID)
    field = TensorVMSplit(TConfig(**dataclasses.asdict(CFG)), GRID, device="cpu")
    field.load_state_dict(params_from_jax(_flat(params)))
    vol = (np.random.default_rng(7).uniform(size=(10, 10, 10)) < 0.35).astype(np.float32)
    jmask, pmask = both_masks(vol)
    return params, field, jmask, pmask


# ---- the coarse pre-gate ---------------------------------------------------------


def test_coarse_gate_functions_match_jax(setup, rng):
    _, _, jmask, pmask = setup
    np.testing.assert_array_equal(pmask.coarse.numpy(), np.asarray(jmask.coarse))
    for n in (1, 5, 128, 130):
        np.testing.assert_array_equal(tam.coarse_probe_indices(n), jam.coarse_probe_indices(n))
    xyz = rng.uniform(-1.7, 1.7, size=(40, 130, 3)).astype(np.float32)
    np.testing.assert_array_equal(tam.coarse_probe_hits(pmask, t(xyz)).numpy(),
                                  np.asarray(jam.coarse_probe_hits(jmask, jnp.asarray(xyz))))
    # a mask without its derived volumes builds them on the fly
    bare = tam.AlphaGridMask(pmask.aabb, pmask.volume)
    np.testing.assert_array_equal(tam.coarse_probe_hits(bare, t(xyz)).numpy(),
                                  tam.coarse_probe_hits(pmask, t(xyz)).numpy())
    gate = tam.sample_alpha_gate_coarse(pmask, t(xyz))
    np.testing.assert_array_equal(
        gate.numpy(), np.asarray(jam.sample_alpha_gate_coarse(jmask, jnp.asarray(xyz))))
    for n in (128, 130, 3):
        cand = rng.uniform(size=(17, n)) < 0.2
        got = tam.group_padded_count(t(cand))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jam.group_padded_count(jnp.asarray(cand))))


# ---- render_rays' budget modes -------------------------------------------------

MODES = {
    # name: (mask, render keywords)
    "cand_windows": (True, dict(sample_budget=48, budget_mode="cand")),
    "cand_windows_cover": (True, dict(sample_budget=96, budget_mode="cand")),
    "cand_samples": (True, dict(sample_budget=50, budget_mode="cand")),
    "cand_unfused": (True, dict(sample_budget=48, budget_mode="cand", fused=False,
                                shade_top_k=None)),
    "cand_alive_budget": (True, dict(sample_budget=96, budget_mode="cand", alive_budget=32)),
    "alive_two_stage": (True, dict(sample_budget=32, budget_mode="alive", n_samples=300)),
    "exact_gate": (True, dict(sample_budget=40, use_coarse_gate=False)),
    "prefilter_windows": (False, dict(sample_budget=64, budget_mode="cand")),
    "prefilter_samples": (False, dict(sample_budget=50)),
}


def _lattice_index(z, rays, u, n_samples):
    """The lattice index of each returned sample depth."""
    t_min = sample_lattice(t(rays[:, :3]), t(rays[:, 3:6]), t(AABB), *NEAR_FAR).numpy()
    off = 0.0 if u is None else u.numpy()
    return np.rint((np.asarray(z) - t_min[:, None]) / STEP - off).astype(np.int64)


@pytest.mark.parametrize("keyed", [False, True], ids=["eval", "jitter"])
@pytest.mark.parametrize("mode", list(MODES))
def test_budget_modes_match_jax(setup, rng, mode, keyed):
    params, field, jmask, pmask = setup
    masked, extra = MODES[mode]
    rays = _rays(rng, 64)
    key = jax.random.PRNGKey(5) if keyed else None
    u = flip = None
    if keyed:
        k_strat, k_bg = jax.random.split(key)
        u = t(jax.random.uniform(k_strat, (64, 1), dtype=jnp.float32))
        flip = t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32))
    kw = dict(step_size=STEP, n_samples=NS, is_train=keyed, white_bg=True, ndc_ray=False,
              shade_top_k=16, fused=True)
    kw.update(extra)
    want = j_render(JM, CFG, params, jmask if masked else None, jnp.asarray(rays), key,
                    JMasks(), aabb=jnp.asarray(AABB), **kw)
    with torch.no_grad():
        got = tvolume.render_rays(field, t(rays), TMasks(), aabb=t(AABB),
                                  alpha_mask=pmask if masked else None, u=u, flip=flip, **kw)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-4, atol=1e-4)
    for name in ("weights", "sigma", "z_vals"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert float(got.budget_overflow_frac) == float(want.budget_overflow_frac)
    assert float(got.mean_alive_samples) == float(want.mean_alive_samples)
    assert int(got.num_valid_samples) == int(want.num_valid_samples)
    # the compacted width and the selected lattice indices, index for index
    width = extra.get("alive_budget") or extra["sample_budget"]
    assert got.z_vals.shape == (64, width)
    sel = _lattice_index(got.z_vals, rays, u, kw["n_samples"])
    np.testing.assert_array_equal(sel, _lattice_index(want.z_vals, rays, u, kw["n_samples"]))
    assert (np.diff(sel, axis=1) > 0).all()  # depth order


def test_budget_covering_every_candidate_is_exact(setup, rng):
    """A cand budget that covers every ray's count renders what the
    unbudgeted masked render does, and a too-small one reports overflow."""
    _, field, _, pmask = setup
    rays = _rays(rng, 64)
    counts = tcull.count_ray_candidates(t(rays), pmask, AABB, STEP, NEAR_FAR, n_samples=NS)
    budget = tcull._budget_hint(int(counts.max()))
    assert budget < NS
    kw = dict(aabb=t(AABB), step_size=STEP, n_samples=NS, is_train=False, white_bg=True,
              alpha_mask=pmask, shade_top_k=16)
    full = _render(field, t(rays), TMasks(), **kw)
    cut = _render(field, t(rays), TMasks(), sample_budget=budget, budget_mode="cand", **kw)
    assert float(cut.budget_overflow_frac) == 0.0
    np.testing.assert_allclose(cut.rgb.numpy(), full.rgb.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cut.depth.numpy(), full.depth.numpy(), rtol=1e-4, atol=1e-4)
    tiny = _render(field, t(rays), TMasks(), sample_budget=8, budget_mode="cand", **kw)
    assert float(tiny.budget_overflow_frac) > 0.0


@pytest.mark.parametrize("case", ["eval_masked", "jitter_masked", "jitter_mask_free"])
def test_derived_compaction_equals_gathered(setup, rng, monkeypatch, case):
    """Derived window compaction (indices re-materialized from the affine
    lattice) equals gathering from the full lattice, field for field."""
    _, field, _, pmask = setup
    rays = t(_rays(rng, 64))
    u = None if case == "eval_masked" else torch.rand((64, 1), generator=torch.Generator().manual_seed(3))
    mask = None if case == "jitter_mask_free" else pmask
    outs = []
    for derived in (True, False):
        monkeypatch.setattr(tvolume, "_DERIVED_COMPACTION", derived)
        outs.append(tvolume.render_rays(
            field, rays, TMasks(), aabb=t(AABB), step_size=STEP, n_samples=NS, is_train=u is not None,
            white_bg=True, sample_budget=64, budget_mode="cand", alpha_mask=mask, u=u))
    for name in tvolume.RenderOutput._fields:
        np.testing.assert_array_equal(getattr(outs[0], name).detach().numpy(),
                                      getattr(outs[1], name).detach().numpy(), err_msg=name)


# ---- the count passes ------------------------------------------------------------


def test_count_passes_match_jax(setup, rng):
    """Exact against the JAX passes run op by op (jax.disable_jit: the
    arithmetic as written).  Compiled, XLA moves a boundary sample of the
    exact gate by float32 rounding now and then: within one sample (one
    window for the padded counts) of the port there."""
    _, _, jmask, pmask = setup
    rays = _rays(rng, 300)
    rays[:30, 3:6] *= -1.0  # misses: zero counts
    args = (AABB, STEP, NEAR_FAR)
    jkw = dict(n_samples=NS, chunk=128)
    tkw = dict(n_samples=NS, chunk=70)
    got = [tcull.count_ray_candidates(t(rays), pmask, *args, use_coarse=c, **tkw) for c in (True, False)]
    got += tcull.count_ray_candidates_and_chord(t(rays), pmask, *args, **tkw)
    got += [tcull.count_ray_inbbox(t(rays), *args, **tkw)]
    got += tcull.count_ray_candidates_and_alive(t(rays), pmask, *args, **tkw)

    def jax_counts():
        out = [jcull.count_ray_candidates(rays, jmask, *args, use_coarse=c, **jkw) for c in (True, False)]
        out += jcull.count_ray_candidates_and_chord(rays, jmask, *args, **jkw)
        out += [jcull.count_ray_inbbox(rays, *args, **jkw)]
        return out + list(jcull.count_ray_candidates_and_alive(rays, jmask, *args, **jkw))

    with jax.disable_jit():
        want = jax_counts()
    slack = (4, 1, 4, 1, 4, 4, 1, 1)
    for g, w, c, s in zip(got, want, jax_counts(), slack, strict=True):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        assert np.abs(g - c).max() <= s
    assert (got[0][:30] == 0).all() and got[0][30:].max() > 0


# ---- the numpy strata plan and the samplers ---------------------------------------


def _random_counts(rng, n=3000):
    return np.concatenate([
        np.zeros(rng.integers(0, n // 2), np.int64),
        rng.integers(1, 80, n // 3),
        rng.integers(80, 500, rng.integers(1, n // 4)),
        rng.integers(500, 1048, rng.integers(1, 40)),
    ])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_strata_plan_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    counts = _random_counts(rng)
    hist = tcull.count_histogram(counts)
    np.testing.assert_array_equal(hist, jcull.count_histogram(counts))
    np.testing.assert_array_equal(tcull.count_histogram(counts, 600),
                                  jcull.count_histogram(counts, 600))
    for q in (0.0, 0.37, 0.5, 0.999, 1.0):
        assert tcull._hist_quantile(hist, q) == jcull._hist_quantile(hist, q)
        np.testing.assert_allclose(tcull._hist_quantile(hist, q), np.quantile(counts, q))
    assert tcull._optimal_edges(hist) == jcull._optimal_edges(hist)
    for quantiles in (None, (0.5, 0.8, 0.95)):
        assert tcull.stratify_edges(hist, quantiles) == jcull.stratify_edges(hist, quantiles)
        got, want = tcull.stratify_rays(counts, quantiles), jcull.stratify_rays(counts, quantiles)
        assert got[1] == want[1]
        for a, b in zip(got[0], want[0], strict=True):
            np.testing.assert_array_equal(a, b)
    cand = counts + rng.integers(0, 120, counts.size)
    got, want = tcull.stratify_rays_joint(cand, counts), jcull.stratify_rays_joint(cand, counts)
    assert got[1:] == want[1:]
    for a, b in zip(got[0], want[0], strict=True):
        np.testing.assert_array_equal(a, b)
    sizes = [int(s.size) for s in got[0]]
    for batch, r in ((4096, 8), (1024, 8), (8 * len(sizes), 8)):
        assert tsampler.allocate_quotas(sizes, batch, r) == jsampler.allocate_quotas(sizes, batch, r)
    for sizes in ([900, 100], [512, 512, 64], [10000, 8], [5000, 3000, 1500, 500]):
        assert tsampler.allocate_quotas(sizes, 1024, 8) == jsampler.allocate_quotas(sizes, 1024, 8)


def test_stratified_sampler_draws_from_own_stratum():
    strata = [np.arange(0, 100), np.arange(100, 160), np.arange(160, 165)]
    s = tsampler.StratifiedSampler(strata, [16, 8, 8], seed=3)
    assert [smp._gen.initial_seed() for smp in s.samplers] == [3, 3 + 7919, 3 + 2 * 7919]
    seen = []
    for _ in range(30):
        ids = s.nextids()
        assert tuple(i.shape for i in ids) == ((16,), (8,), (8,))
        assert all(i.dtype == torch.int64 for i in ids)
        assert (ids[0] < 100).all() and ((ids[1] >= 100) & (ids[1] < 160)).all()
        assert ((ids[2] >= 160) & (ids[2] < 165)).all()  # a stratum under its quota tiles
        seen.append(ids[1])
    assert set(torch.cat(seen).tolist()) == set(range(100, 160))


def test_multinomial_shares_distribution():
    """Mean p and variance p(1-p)/n of the noise-matched stratum shares, as
    tests/test_stratified.py holds the JAX draw to; the JAX draw itself
    passes the same check here."""
    probs = (0.55, 0.3, 0.1, 0.05)
    n = 2048.0
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tstep._multinomial_shares(gen, n, probs, "cpu") for _ in range(200)]).numpy()
    jdraws = np.stack([np.asarray(jnp.stack(j_shares(jax.random.PRNGKey(k), n, probs)))
                       for k in range(200)])
    p = np.asarray(probs)
    for d in (draws, jdraws):
        assert (d >= 0).all()
        np.testing.assert_allclose(d.sum(1), 1.0, atol=1e-6)
        np.testing.assert_allclose(d * n, np.round(d * n), atol=1e-3)
        np.testing.assert_allclose(d.mean(0), p, atol=0.01)
        np.testing.assert_allclose(d.var(0), p * (1 - p) / n, rtol=0.35)


# ---- the loop: restratify and the budget auto-raise ---------------------------------


def _state(tmp_path, **over):
    base = dict(stratify=1, n_iters=10, N_voxel_init=16**3,
                N_voxel_final=20**3, upsamp_list=[6], update_AlphaMask_list=[4],
                batch_size=256, downsample_train=1, basedir=str(tmp_path), seed=3,
                n_lamb_sigma=[4, 4, 4], n_lamb_sh=[6, 6, 6], data_dim_color=9, featureC=32)
    cfg = load_config("configs/synth_sphere.txt", dict(base, **over))
    scene = make_synthetic_scene_arrays(n_train=3, n_test=1, wh=(32, 32), scene="sphere")
    return tloop.TrainState(cfg, torch.device("cpu"), scene)


def _jax_plan(state, jmask):
    """tensorf_tpu loop.py:638-782 composed from the JAX pieces, single host."""
    cfg, n = state.cfg, state.n_samples
    rays = state.rays.numpy()
    args = (state.geometry.aabb_np, state.geometry.step_size, state.near_far)
    alive = None
    if jmask is None:
        counts = chord = jcull.count_ray_inbbox(rays, *args, n_samples=n, chunk=512)
    elif jam.coarse_gate_valid(jmask, state.geometry.step_size, False):
        if cfg.stratify_alive:
            counts, alive, chord = jcull.count_ray_candidates_and_alive(rays, jmask, *args,
                                                                        n_samples=n, chunk=512)
        else:
            counts, chord = jcull.count_ray_candidates_and_chord(rays, jmask, *args, n_samples=n,
                                                                 chunk=512)
    else:
        counts = jcull.count_ray_candidates(rays, jmask, *args, n_samples=n, chunk=512,
                                            use_coarse=False)
        chord = None
    quantiles = tuple(cfg.strata_quantiles) if cfg.strata_quantiles else None
    if alive is not None:
        strata, budgets, hints = jcull.stratify_rays_joint(counts, alive, quantiles=quantiles)
    else:
        (strata, budgets), hints = jcull.stratify_rays(counts, quantiles=quantiles), None
    sizes = [s.size for s in strata]
    if len(strata) * 8 > cfg.batch_size:
        return None
    budgets = [b if b < n else None for b in budgets]
    lattices = None if chord is None else [
        min(n, jcull._budget_hint(int(chord[sel].max()))) for sel in strata]
    alive_budgets = None
    if hints is not None:
        alive_budgets = [a if (a is not None and b is not None and a < b) else None
                         for a, b in zip(hints, budgets)]
        if not any(a is not None for a in alive_budgets):
            alive_budgets = None
    return dict(strata=strata, quotas=jsampler.allocate_quotas(sizes, cfg.batch_size, 8),
                budgets=budgets, lattices=lattices, alive_budgets=alive_budgets,
                loss_w=[s / float(sum(sizes)) for s in sizes])


@pytest.mark.parametrize("case", ["prefilter", "masked", "masked_alive", "exact_gate",
                                  "quantiles", "batch_too_small"])
def test_restratify_matches_the_jax_loop(tmp_path, rng, case):
    over = {"masked_alive": dict(stratify_alive=1), "quantiles": dict(strata_quantiles=[0.5, 0.9]),
            "batch_too_small": dict(batch_size=8)}.get(case, {})
    state = _state(tmp_path, **over)
    jmask = None
    if case != "prefilter":
        # a 60^3 mask has voxels finer than twice the step: no coarse gate
        shape = (60, 60, 60) if case == "exact_gate" else (10, 10, 10)
        vol = (rng.uniform(size=shape) < 0.3).astype(np.float32)
        jmask, state.alpha_mask = both_masks(vol, state.geometry.aabb_np)
    assert state.coarse_ok() == (case != "exact_gate")
    want = _jax_plan(state, jmask)
    logs = []
    plan = tloop.restratify(state, 7, logs.append)
    if want is None:
        assert plan is None and state.strata_budgets is None
        assert isinstance(state.sampler, tsampler.SimpleSampler)
        assert "stratify skipped (batch too small)" in logs[0]
        return
    assert len(want["strata"]) > 1 or case == "quantiles"
    for got, exp in zip(state.sampler.strata, want["strata"], strict=True):
        np.testing.assert_array_equal(got.numpy(), exp)
    assert plan["quotas"] == state.quotas == state.sampler.quotas == want["quotas"]
    assert state.strata_budgets == want["budgets"]
    assert (list(state.strata_n_samples) if state.strata_n_samples else None) == want["lattices"]
    assert state.strata_alive_budgets == want["alive_budgets"]
    assert state.strata_loss_w == want["loss_w"]
    assert state.overflow_strikes == [0] * len(want["strata"])
    statics = tloop.build_statics(state)
    assert statics.strata_budgets == tuple(want["budgets"])
    assert statics.strata_loss_weights == tuple(want["loss_w"])
    assert statics.use_coarse_gate == (case != "exact_gate")
    assert (plan["mean_alive"] is not None) == (case == "masked_alive")
    if case == "prefilter":
        # the chord lattice is the budget: every stratum renders unbudgeted
        assert tstep.render_widths(statics) == list(statics.strata_n_samples)
    assert "stratified ray store" in logs[-1]
    # stratify=0 deactivates: the plain sampler, reseeded, and no strata
    state.cfg = dataclasses.replace(state.cfg, stratify=0)
    assert tloop.restratify(state, 9) is None
    assert state.strata_budgets is None and state.quotas is None
    assert isinstance(state.sampler, tsampler.SimpleSampler)
    assert state.sampler._gen.initial_seed() == state.cfg.seed + 9


def test_budget_auto_raise_follows_the_jax_rule(tmp_path):
    """tensorf_tpu loop.py:1046-1136: two progress reads in a row above 1%
    raise a budget to ceil32(1.5 b); with strata per stratum (None once it
    reaches n_samples, with its alive cap alongside), else the phase's own
    budget capped at n_samples."""
    state = _state(tmp_path, sample_budget=160, prefilter_budget=96)
    state.n_samples = 380
    state.strata_budgets = [64, 256, 96]
    state.strata_alive_budgets = [None, None, 64]
    state.overflow_strikes = [0, 0, 0]
    assert tloop.raise_budgets(state, [0.02, 0.5, 0.011], 10) == []
    assert state.overflow_strikes == [1, 1, 1]
    assert tloop.raise_budgets(state, [0.0, 0.5, 0.03], 20) == [
        "stratum 1 -> None", "stratum 2 -> 160", "stratum 2 alive -> 96"]
    assert state.strata_budgets == [64, None, 160] and state.strata_alive_budgets == [None, None, 96]
    assert state.overflow_strikes == [0, 0, 0]
    assert tloop.raise_budgets(state, [0.01, float("nan"), 0.2], 30) == []
    assert state.overflow_strikes == [0, 0, 1]
    # unstratified: the prefilter budget before the mask, sample_budget after
    state.strata_budgets = state.strata_alive_budgets = None
    for _ in range(2):
        raised = tloop.raise_budgets(state, [0.05], 40)
    assert raised == ["prefilter_budget -> 160"] and state.prefilter_run == 160
    state.alpha_mask = object()
    tloop.raise_budgets(state, [0.05], 50)
    assert tloop.raise_budgets(state, [0.05], 60) == ["sample_budget -> 256"]


# ---- the stratified step ------------------------------------------------------------


def _capture_grads():
    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


STEP_CASES = {
    # strata budgets, lattices, alive budgets, noise-matched, white background
    "noise_matched": ((48, 96, None), (64, 128, 128), None, True, True),
    "alive_stage_flip": ((64, 96), None, (None, 32), False, False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_stratified_step_gradients_match_jax(setup, case):
    params, field, jmask, pmask = setup
    budgets, lattices, alive, noise_match, white_bg = STEP_CASES[case]
    store = _rays(np.random.default_rng(5), 256)
    rgbs = np.random.default_rng(6).uniform(size=(256, 3)).astype(np.float32)
    d = np.random.default_rng(8)
    ids = tuple(np.asarray(d.integers(0, 256, size=n), np.int32) for n in (24, 16, 8)[:len(budgets)])
    common = dict(n_samples=NS, step_size=STEP, white_bg=white_bg, ndc_ray=False, total_steps=100,
                  lr_factor=0.999, free_reg=True, free_decomp=True, freq_reg_ratio=0.8,
                  shade_top_k=16, fused=True, strata_budgets=budgets,
                  strata_alive_budgets=alive, strata_n_samples=lattices,
                  strata_loss_weights=(0.5, 0.3, 0.2)[:len(budgets)],
                  strata_noise_match=noise_match)
    weights = dict(ortho=0.01, l1=8e-5, tv_density=0.01, tv_app=0.01, occ=0.1, occ_range=5)
    tx = _capture_grads()
    j_step = j_make_train_step(JM, CFG, JStatics(weights=JWeights(**weights), from_store=True,
                                                 **common), tx)
    key = jax.random.PRNGKey(11)
    _, opt_state, metrics = j_step(
        jax.tree.map(jnp.copy, params), tx.init(params), jmask, jnp.asarray(AABB),
        jnp.asarray(store), jnp.asarray(rgbs), tuple(jnp.asarray(i) for i in ids),
        jnp.asarray(3, jnp.int32), key)
    j_grads = {k.replace("/", "."): v for k, v in _flat(opt_state["g"]).items()}

    # the JAX step's draws (tensorf_tpu/train/step.py:213-220, volume.py:137-138)
    shares = None
    statics = tstep.TrainStatics(weights=TWeights(**weights), **common)
    if noise_match:
        key, key_comp = jax.random.split(key)
        shares = t(jnp.stack(j_shares(key_comp, 48.0, tuple(tstep.strata_loss_shares(
            statics, [len(i) for i in ids])))))
        assert not np.allclose(shares.numpy(), [0.5, 0.3, 0.2])
    us, flips = [], []
    for k, ids_s in zip(jax.random.split(key, len(ids)), ids):
        k_strat, k_bg = jax.random.split(k)
        us.append(t(jax.random.uniform(k_strat, (len(ids_s), 1), dtype=jnp.float32)))
        flips.append(t((jax.random.uniform(k_bg, ()) < 0.5).astype(jnp.float32)))
    field.zero_grad(set_to_none=True)
    calls = []

    def counting(idx, g, n_rows):
        calls.append(g.shape[1])
        return scatter_add_reference(idx, g, n_rows)

    with mock.patch.object(grid_sample, "scatter_add", counting):
        total, t_metrics = tstep.loss_fn(
            field, statics, t(AABB), tuple(t(store[i]) for i in ids), tuple(t(rgbs[i]) for i in ids),
            3, us, flips, pmask, shares)
        total.backward()
    np.testing.assert_allclose(float(total.detach()), float(metrics["total_loss"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_metrics["stratum_overflow"].numpy(),
                               np.asarray(metrics["stratum_overflow"]))
    np.testing.assert_allclose(float(t_metrics["budget_overflow_frac"]),
                               float(metrics["budget_overflow_frac"]), rtol=1e-6)
    grads = {name: p.grad for name, p in field.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[name], err_msg=name, **GRAD)
    # one scatter-add per gathered plane table: 6 where top-K shading splits
    # density from appearance, 3 where it does not
    want = sum(6 if 16 < w else 3 for w in tstep.render_widths(statics))
    assert len(calls) == want
    field.zero_grad(set_to_none=True)


def test_stratified_step_fn_gathers_from_the_store(setup):
    _, field, _, pmask = setup
    field = TensorVMSplit(TConfig(**dataclasses.asdict(CFG)), GRID, device="cpu")
    statics = tstep.TrainStatics(
        n_samples=NS, step_size=STEP, white_bg=True, ndc_ray=False, total_steps=100,
        lr_factor=0.999, shade_top_k=16, strata_budgets=(48, None), strata_n_samples=(128, 128),
        strata_loss_weights=(0.7, 0.3), strata_noise_match=True)
    from tensorf_tpu_torch.train import make_optimizer

    step_fn = tstep.make_train_step(field, statics, make_optimizer(field, 0.02, 1e-3, 0.99))
    store = t(_rays(np.random.default_rng(1), 100))
    ids = (torch.arange(0, 16), torch.arange(50, 58))
    metrics = step_fn(t(AABB), store, torch.rand(100, 3), 0, torch.Generator().manual_seed(0),
                      pmask, ids=ids)
    assert np.isfinite(float(metrics["total_loss"])) and metrics["stratum_overflow"].shape == (2,)


# ---- a tiny stratified schedule ---------------------------------------------------------


def test_tiny_stratified_reconstruction(tmp_path):
    """synth_sphere's schedule cut to 10 steps with stratification and both
    budgets on: every event fires and restratifies, every segment draws
    strata, the losses and the test PSNR are finite, and the final
    evaluation renders at the budget."""
    cfg = load_config("configs/synth_sphere.txt", dict(
        n_iters=10, N_voxel_init=10**3, N_voxel_final=16**3,
        upsamp_list=[3, 6], update_AlphaMask_list=[4, 7], batch_size=256, downsample_train=1,
        vis_every=5, save_ckpt_every=[], progress_refresh_rate=1, seed=3, sample_budget=64,
        prefilter_budget=96, basedir=str(tmp_path)))
    assert cfg.stratify == 1
    scene = make_synthetic_scene_arrays(n_train=4, n_test=1, wh=(40, 40), scene="sphere")
    logs = []
    res = tloop.reconstruction(cfg, scene, "cpu", save_images=False, log=logs.append)
    assert [e["event"] for e in res.events] == ["upsample", "alpha_mask", "upsample", "alpha_mask"]
    assert [p["iteration"] for p in res.plans if p["event"] == "stratify"] == [0, 3, 4, 6, 7]
    assert all(s["strata"] > 1 for s in res.segments), res.segments
    assert all(s["samples_per_step"] > 0 for s in res.segments)
    assert np.all(np.isfinite(res.total_loss)) and np.isfinite(np.mean(res.final_psnrs))
    assert np.isfinite(res.test_psnrs[5])
    assert any("overflow [" in line for line in logs)
    assert tloop.make_handle(res.state).sample_budget == (64 if 64 < res.state.n_samples else None)
