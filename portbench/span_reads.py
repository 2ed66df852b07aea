"""What the readers of the port's own spans and counters compute
(``metrics/<name>.py``): the device's idle time a unit by the phase of the
step or view that the host was in, and the share of the render's sample
slots that were of use.

The port (``tensorf_tpu_torch/utils/tracing.py``) marks its phases with
host events named ``tftorch.*``, on the profiler's clock, and counts the
render's slots while a profiler runs.  ``trace.py`` keeps those events
among ``DeviceTrace.host``.  A program without them gives nothing to read,
and every reader here then returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "tftorch."

# the phases whose idle time is reported, by kind of unit; the host runs
# one at a time, so they do not overlap
PHASES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "train": {
        "sample": ("tftorch.train.sample", "tftorch.train.batch"),
        "forward": ("tftorch.train.forward",),
        "backward": ("tftorch.train.backward",),
        "optim": ("tftorch.train.optim",),
    },
    "serve": {
        "count": ("tftorch.serve.count",),
        "bucket": ("tftorch.serve.bucket",),
        "fetch": ("tftorch.serve.fetch",),
    },
}

Intervals = List[Tuple[float, float]]


def union(intervals: Sequence[Tuple[float, float]]) -> Intervals:
    """Sorted, disjoint intervals covering ``intervals``."""
    out: Intervals = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap(a: Intervals, b: Intervals) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> Optional[Intervals]:
    """The device-idle pieces (us) of the profiled region, which runs from
    the earlier of the first ``tftorch.`` span and the first device activity
    to the later of their last ends; None without a ``tftorch.`` span."""
    marks = [(s, e) for s, e, name in trace.host if name.startswith(PREFIX)]
    if not marks:
        return None
    busy = union(trace.spans)
    lo = min([s for s, _ in marks] + [s for s, _ in busy[:1]])
    hi = max([e for _, e in marks] + [e for _, e in busy[-1:]])
    idle, cur = [], lo
    for s, e in busy:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        idle.append((cur, hi))
    return idle


def idle_by_phase(ctx, kind: str) -> Optional[Dict[str, float]]:
    """ms a unit of the unprofiled idle time (unprofiled wall a unit less
    profiled busy a unit, as ``device_idle_pct`` takes it), split as the
    profiled idle time falls inside each phase's spans, on any thread;
    ``unattributed`` is the rest, so the parts sum to the whole."""
    if ctx["kind"] != kind:
        return None
    trace = ctx["trace"]
    idle = idle_intervals(trace)
    if idle is None:
        return None
    total = sum(e - s for s, e in idle)
    per_unit_ms = 1e3 * (ctx["plain_wall_s"] - trace.busy_us / 1e6 / ctx["units"])
    out = {}
    for phase, names in PHASES[kind].items():
        inside = overlap(idle, union([(s, e) for s, e, name in trace.host if name in names]))
        out[phase] = per_unit_ms * inside / total if total > 0 else 0.0
    out["unattributed"] = per_unit_ms - sum(out.values())
    return out


def phase_idle_ms(ctx, kind: str, phase: str) -> Optional[float]:
    parts = idle_by_phase(ctx, kind)
    return None if parts is None else parts[phase]


def port_counts(ctx) -> Optional[dict]:
    """The counters the port recorded while the profiler ran (taken once a
    run, then kept in ``ctx``); None for a port without them."""
    if "port_counts" not in ctx:
        try:
            from tensorf_tpu_torch.utils import tracing
        except ImportError:
            ctx["port_counts"] = None
        else:
            ctx["port_counts"] = tracing.take_counts()
    return ctx["port_counts"]


def slot_use_pct(ctx, kind: str, used: str, slots: str) -> Optional[float]:
    """100 x counter ``used`` / counter ``slots``."""
    if ctx["kind"] != kind:
        return None
    counts = port_counts(ctx)
    if not counts or not counts.get(slots):
        return None
    return 100.0 * counts.get(used, 0.0) / counts[slots]
