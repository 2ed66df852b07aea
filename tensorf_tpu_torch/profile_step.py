"""Where a train step's device time goes: torch.profiler over a few steps.

    python -m tensorf_tpu_torch.profile_step [--last_segment]

Trains configs/synth_full.txt's model (with stratification and budgets off,
as the port runs it) on the in-memory composite scene (8 views, 200x200 px).
By default it takes WARMUP steps of the first (128^3) segment unprofiled,
past the initial loss plateau, then profiles STEPS steps.  With
``--last_segment`` it runs the cut schedule chip_smoke.py drives
(CUT_SCHEDULE: 450 steps, both alpha-mask events, five upsamples to
n_to_reso(300^3) on the shrunk bbox) and profiles its last STEPS steps:
the masked top-32 step at the final grid.  It prints, per CUDA kernel, its
device time per step and share, then the same time by the torch op (and
input shapes) that launched it, the step's wall time, and the device's
busy and idle share of that wall time (the profiler's own overhead
included).  Busy time is the union of the kernel, memcpy and memset
intervals; user-annotation rows, which span kernels already counted, are
left out.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .config import load_config
from .data.synthetic import make_synthetic_scene_arrays
from .train.loop import reconstruction, train_steps

CONFIG = "configs/synth_full.txt"
# the knobs not ported yet, off
OVERRIDES = dict(stratify=0, stratify_render=0, sample_budget=0, prefilter_budget=0,
                 progress_refresh_rate=10**9)
# synth_full's 30000-step schedule cut to 450 steps: the same events, 50
# steps apart.  The LR still decays over the config's 30000 steps: decayed
# over 450, it slows the field's escape from its initial plateau past the
# first alpha mask at 200, which then finds nothing occupied.
CUT_SCHEDULE = dict(n_iters=450, lr_decay_iters=30000, upsamp_list=[200, 250, 300, 350, 400],
                    update_AlphaMask_list=[200, 300], vis_every=200, save_ckpt_every=[])
WARMUP = 160
STEPS = 5
TOP = 25


def _busy_ms(events) -> float:
    """Length of the union of the device activity intervals, in ms."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type.name == "CUDA" and not e.is_user_annotation
    )
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy / 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--last_segment", action="store_true",
                        help="profile the last steps of the cut schedule, not the first segment")
    args = parser.parse_args(argv)
    scene = make_synthetic_scene_arrays(n_train=8, n_test=2, wh=(200, 200), scene="composite")
    state = {}
    first = CUT_SCHEDULE["n_iters"] - STEPS if args.last_segment else WARMUP

    def on_step(it: int, *_) -> None:  # runs after step ``it`` is enqueued
        if it == first - 1:
            torch.cuda.synchronize()
            state["prof"] = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True
            )
            state["prof"].__enter__()
            state["t0"] = time.perf_counter()
        if it == first + STEPS - 1:
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - state["t0"]
            state["prof"].__exit__(None, None, None)

    if args.last_segment:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = load_config(CONFIG, dict(OVERRIDES, **CUT_SCHEDULE, basedir=tmp, render_test=0))
            result = reconstruction(cfg, scene, "cuda", save_images=False, on_step=on_step,
                                    log=lambda s: None)
        geometry = result.state.geometry
        where = (f"the last {STEPS} steps of the cut schedule: grid {geometry.grid_size}, "
                 f"{result.state.n_samples} samples, alpha mask, top-{cfg.shade_top_k}")
    else:
        cfg = load_config(CONFIG, OVERRIDES)
        train_steps(cfg, WARMUP + STEPS, device="cuda", scene=scene, on_step=on_step,
                    log=lambda s: None)
        where = f"{STEPS} profiled steps after {WARMUP}"
    prof, wall_ms = state["prof"], state["wall"] * 1e3 / STEPS
    annotations = {e.key for e in prof.events() if e.is_user_annotation}
    rows = [
        (e.key, e.device_time_total / 1e3 / STEPS, e.count // STEPS)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type.name == "CUDA"
        and e.key not in annotations
    ]
    busy_ms = _busy_ms(prof.events()) / STEPS
    print(f"{torch.cuda.get_device_name(0)}; {where}")
    print(f"wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%; "
          f"kernel rows sum to {sum(ms for _, ms, _ in rows):.3f} ms/step")
    print(f"{'ms/step':>9} {'share':>6} {'calls':>6}  kernel")
    for key, ms, calls in sorted(rows, key=lambda r: -r[1])[:TOP]:
        print(f"{ms:9.3f} {100 * ms / busy_ms:5.1f}% {calls:6d}  {key[:110]}")
    # the same device time attributed to the torch ops that launched it
    ops = [
        (e.key, str(e.input_shapes)[:70], e.self_device_time_total / 1e3 / STEPS,
         e.count // STEPS)
        for e in prof.key_averages(group_by_input_shape=True)
        if e.self_device_time_total > 0 and e.device_type.name == "CPU"
    ]
    print(f"{'ms/step':>9} {'share':>6} {'calls':>6}  op [input shapes]")
    for key, shapes, ms, calls in sorted(ops, key=lambda r: -r[2])[:TOP]:
        print(f"{ms:9.3f} {100 * ms / busy_ms:5.1f}% {calls:6d}  {key} {shapes}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
