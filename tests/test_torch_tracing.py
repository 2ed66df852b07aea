"""The port's spans and counters (utils/tracing.py).

Off, a train step and a stratified view record nothing.  Under
``torch.profiler`` every span of the step, the loop and serving is a host
event (not a user annotation) nested as the step and the view nest; the
render counters equal the step's own sample counts; the scatter-add shapes
equal what a wrapper around the call records; and ``--profile_dir`` writes
a Chrome trace of ``profile_steps`` steps.  A tiny synth_full field (12^3,
a 35%-occupied 10^3 mask, 16x16 photos) on the CPU.
"""

import dataclasses
import glob
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensorf_tpu_torch.config import load_config
from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
from tensorf_tpu_torch.models import alpha_mask as tam
from tensorf_tpu_torch.ops import grid_sample as gs
from tensorf_tpu_torch.train import loop as tloop
from tensorf_tpu_torch.train.step import draw_strata_noise, make_train_step, render_widths
from tensorf_tpu_torch.utils import tracing

SMALL = dict(N_voxel_init=12**3, batch_size=128, n_lamb_sigma=[2, 2, 2], n_lamb_sh=[3, 3, 3],
             data_dim_color=6, featureC=16)
STEP_PHASES = ("tftorch.train.batch", "tftorch.train.optim", "tftorch.train.forward",
               "tftorch.train.backward")
RENDER_PARTS = ("tftorch.render.march", "tftorch.render.density", "tftorch.render.shade",
                "tftorch.render.composite")


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene_arrays(n_train=3, n_test=1, wh=(16, 16), scene="composite")


@pytest.fixture(autouse=True)
def no_counts():
    tracing.take_counts()
    yield
    tracing.take_counts()


def _state(scene, masked=True, **over):
    """A TrainState whose density is high enough to shade, with a random
    mask, partitioned for iteration 0."""
    cfg = load_config("configs/synth_full.txt", {**SMALL, **over})
    state = tloop.TrainState(cfg, torch.device("cpu"), scene)
    with torch.no_grad():
        for p in list(state.field.density_plane) + list(state.field.density_line):
            p.fill_(1.5)
    if masked:
        vol = (np.random.default_rng(7).uniform(size=(10, 10, 10)) < 0.35).astype(np.float32)
        state.alpha_mask = tam.with_dilation(
            tam.AlphaGridMask(state.aabb.cpu(), torch.from_numpy(vol)))
    tloop.restratify(state, 0, log=lambda s: None)
    return state


def _step(state, it=0, batch_shares=False):
    """One step; ``batch_shares``: a stratified step whose loss shares are
    the strata's shares of the batch."""
    statics = tloop.build_statics(state)
    step_fn = make_train_step(state.field, statics, state.optimizer)
    g = torch.Generator().manual_seed(tloop.step_seed(state.cfg.seed, it))
    ids = state.next_ids()
    noise = None
    if batch_shares:
        sizes = [int(i.shape[0]) for i in ids]
        u, flip, _ = draw_strata_noise(g, statics, sizes, torch.device("cpu"))
        noise = (u, flip, torch.tensor([n / sum(sizes) for n in sizes]))
    return step_fn(state.aabb, state.rays, state.rgbs, it, g, state.alpha_mask, ids=ids,
                   noise=noise)


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("tftorch.")]


def _named(spans, name):
    return [e for e in spans if e.name == name]


def _inside(inner, outer):
    return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_off_records_nothing(scene):
    state = _state(scene)
    assert not tracing.enabled()
    assert tracing.span("tftorch.train.step") is tracing.span("tftorch.serve.view")
    _step(state)
    handle = tloop.make_handle(state)
    assert handle.stratified and handle.alpha_mask is not None
    handle.render(state.test_ds.all_rays[0], chunk=64)
    assert tracing.take_counts() == {}


def test_train_spans_nest_in_the_step(scene):
    state = _state(scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tloop.restratify(state, 0, log=lambda s: None)
        _step(state)
    spans = _spans(prof)
    assert spans and not any(e.is_user_annotation for e in spans)
    (step,) = _named(spans, "tftorch.train.step")
    (sample,) = _named(spans, "tftorch.train.sample")
    (restratify,) = _named(spans, "tftorch.train.restratify")
    # the loop draws the ids before it calls the step
    assert restratify.time_range.end <= sample.time_range.start
    assert sample.time_range.end <= step.time_range.start
    for name in STEP_PHASES:
        assert _named(spans, name) and all(_inside(e, step) for e in _named(spans, name)), name
    assert len(_named(spans, "tftorch.train.optim")) == 2  # zero_grad, the Adam step
    (forward,) = _named(spans, "tftorch.train.forward")
    renders = _named(spans, "tftorch.train.render")
    assert len(renders) == len(state.strata_budgets) > 1
    assert all(_inside(r, forward) for r in renders)
    for name in RENDER_PARTS:
        parts = _named(spans, name)
        assert len(parts) == len(renders), name
        assert all(any(_inside(p, r) for r in renders) for p in parts), name


@pytest.mark.parametrize("coarse", [True, False], ids=["resident", "legacy"])
def test_serve_spans_nest_in_the_view(scene, coarse):
    state = _state(scene)
    handle = dataclasses.replace(tloop.make_handle(state), use_coarse_gate=coarse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        handle.render(state.test_ds.all_rays[0], chunk=64)
    spans = _spans(prof)
    assert spans and not any(e.is_user_annotation for e in spans)
    (view,) = _named(spans, "tftorch.serve.view")
    (count,) = _named(spans, "tftorch.serve.count")
    (fetch,) = _named(spans, "tftorch.serve.fetch")
    buckets = _named(spans, "tftorch.serve.bucket")
    assert buckets and all(_inside(e, view) for e in [count, fetch] + buckets)
    assert all(count.time_range.end <= b.time_range.start for b in buckets)
    assert all(b.time_range.end <= fetch.time_range.start for b in buckets)
    for name in RENDER_PARTS:
        parts = _named(spans, name)
        assert len(parts) >= len(buckets), name
        assert all(any(_inside(p, b) for b in buckets) for p in parts), name


@pytest.mark.parametrize("stratified", [False, True], ids=["uniform", "strata"])
def test_render_counters_equal_the_step_counts(scene, stratified, monkeypatch):
    calls = []
    count = tracing.count

    def recording(name, value, scale=1.0):
        calls.append((name, float(value) * scale))
        count(name, value, scale)

    monkeypatch.setattr(tracing, "count", recording)
    state = _state(scene, **({} if stratified else dict(stratify=0)))
    assert (state.strata_budgets is not None) == stratified
    with profile(activities=[ProfilerActivity.CPU]):
        m = _step(state, batch_shares=stratified)
    counts = tracing.take_counts()
    statics = tloop.build_statics(state)
    batch = state.cfg.batch_size
    sizes = ([q for q in state.quotas] if stratified else [batch])
    widths = render_widths(statics)
    top = statics.shade_top_k
    assert counts["render.rays"] == batch == sum(sizes)
    per_render = {name: [v for n, v in calls if n == name]
                  for name in ("render.density_rows", "render.alive", "render.shade_rows",
                               "render.shaded")}
    # a render whose budget lies below its lattice runs the density on rays x
    # budget; one whose whole lattice the mask gates, on its alive slots alone
    # (every render of this state: its strata's budgets reach their lattices)
    budgets = statics.strata_budgets or (statics.sample_budget,)
    lattices = statics.strata_n_samples or (statics.n_samples,) * len(sizes)
    assert state.alpha_mask is not None
    assert not any(b is not None and b < lat for b, lat in zip(budgets, lattices))
    assert widths == list(lattices)
    assert per_render["render.density_rows"] == [round(a) for a in per_render["render.alive"]]
    assert all(abs(rows - a) < 1e-3 for rows, a in zip(per_render["render.density_rows"],
                                                        per_render["render.alive"]))
    assert counts["render.density_rows"] == sum(per_render["render.density_rows"])
    assert counts["render.density_rows"] < sum(n * w for n, w in zip(sizes, widths))
    if not stratified:
        assert counts["render.density_rows"] == float(m["mean_alive_samples"]) * batch
    # a render shades its rays' top-K slots, or without a top-K below its
    # width just the samples whose weight passes the threshold
    assert per_render["render.shade_rows"] == [
        n * top if top is not None and top < w else shaded
        for n, w, shaded in zip(sizes, widths, per_render["render.shaded"])]
    assert counts["render.shade_rows"] == sum(per_render["render.shade_rows"])
    assert counts["render.shaded"] == float(m["num_valid_samples"]) > 0
    np.testing.assert_allclose(counts["render.alive"], float(m["mean_alive_samples"]) * batch,
                               rtol=1e-6)
    assert 0 < counts["render.shaded"] <= counts["render.shade_rows"]
    # render.alive is a float32 mean times the rays: whole slots, to rounding
    assert 0 < round(counts["render.alive"]) <= counts["render.density_rows"]


def test_scatter_shapes_equal_a_wrapper(scene, monkeypatch):
    state = _state(scene)
    calls = []
    inner = gs.scatter_add

    def recording(idx, g, n_rows):
        calls.append((int(idx.numel()), int(g.shape[1]), int(g.element_size()), int(n_rows)))
        return inner(idx, g, n_rows)

    monkeypatch.setattr(gs, "scatter_add", recording)
    with profile(activities=[ProfilerActivity.CPU]):
        _step(state)
    counts = tracing.take_counts()
    assert calls and counts["scatter_add"] == calls


def test_profile_dir_writes_the_steps_trace(tmp_path):
    """A tiny schedule with --profile_dir: the trace holds profile_steps
    steps (and their progress reads), and the log gives the slot use."""
    cfg = load_config("configs/synth_sphere.txt", dict(
        n_iters=6, N_voxel_init=10**3, N_voxel_final=12**3, upsamp_list=[3],
        update_AlphaMask_list=[4], batch_size=128, vis_every=0, save_ckpt_every=[],
        progress_refresh_rate=1, seed=3, render_test=0, basedir=str(tmp_path),
        profile_dir=str(tmp_path / "trace"), profile_start=1, profile_steps=2))
    scene = make_synthetic_scene_arrays(n_train=2, n_test=1, wh=(16, 16), scene="sphere")
    logs = []
    tloop.reconstruction(cfg, scene, "cpu", save_images=False, log=logs.append)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert any(line == f"[profile] trace written to {path}" for line in logs), logs
    assert any(line.startswith("[profile] density slot use ") and "scatter_add " in line
               for line in logs), logs
    events = json.load(open(path))["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("tftorch.train.step") == 2
    assert names.count("tftorch.train.progress") == 2
    assert not tracing.enabled() and tracing.take_counts() == {}
