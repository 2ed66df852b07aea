"""Where a train step's device time goes: torch.profiler over a few steps.

    python -m tensorf_tpu_torch.profile_step

Trains configs/synth_full.txt's model (with stratification and budgets off,
as the port runs it) on the in-memory composite scene (8 views, 200x200 px),
takes WARMUP steps unprofiled (past the initial loss plateau), then profiles
STEPS steps and prints, per CUDA kernel, its device time per step and share,
then the same time by the torch op (and input shapes) that launched it, the
step's wall time, and the device's busy and idle share of that wall time
(the profiler's own overhead included).  Busy time is the union of the
kernel, memcpy and memset intervals; user-annotation rows, which span
kernels already counted, are left out.  Needs a GPU.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from .config import load_config
from .data.synthetic import make_synthetic_scene_arrays
from .train.loop import train_steps

CONFIG = "configs/synth_full.txt"
OVERRIDES = dict(stratify=0, sample_budget=0, prefilter_budget=0, progress_refresh_rate=10**9)
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


def main() -> int:
    cfg = load_config(CONFIG, OVERRIDES)
    scene = make_synthetic_scene_arrays(n_train=8, n_test=2, wh=(200, 200), scene="composite")
    total = WARMUP + STEPS
    state = {}

    def on_step(it: int) -> None:  # runs after step ``it`` is enqueued
        if it == WARMUP - 1:
            torch.cuda.synchronize()
            state["prof"] = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True
            )
            state["prof"].__enter__()
            state["t0"] = time.perf_counter()
        if it == total - 1:
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - state["t0"]
            state["prof"].__exit__(None, None, None)

    train_steps(cfg, total, device="cuda", scene=scene, on_step=on_step, log=lambda s: None)
    prof, wall_ms = state["prof"], state["wall"] * 1e3 / STEPS
    annotations = {e.key for e in prof.events() if e.is_user_annotation}
    rows = [
        (e.key, e.device_time_total / 1e3 / STEPS, e.count // STEPS)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type.name == "CUDA"
        and e.key not in annotations
    ]
    busy_ms = _busy_ms(prof.events()) / STEPS
    print(f"{torch.cuda.get_device_name(0)}; {STEPS} profiled steps after {WARMUP}")
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
