"""What the per-layer readers (``metrics/<name>.py``) compute from a traced
run's context: the profiled window's device trace, its unit count (steps
or views), the unprofiled wall time a unit, the model FLOPs a unit and the
scatter-add calls' shapes.  A reader that finds nothing to read returns
None and its metric is left out of the line."""

from __future__ import annotations

from .counts import PEAK_F32_FLOPS, PEAK_HBM_BYTES, scatter_bound_bytes

# the scatter-add's two grids a call (csrc/scatter_add.cu)
SCATTER_KERNELS = ("scatter_add_runs_kernel", "zero_fill_kernel")


def idle_pct(ctx, kind: str):
    """100 (1 - device busy a unit / unprofiled wall a unit)."""
    if ctx["kind"] != kind:
        return None
    busy = ctx["trace"].busy_us / 1e6 / ctx["units"]
    return 100.0 * (1.0 - busy / ctx["plain_wall_s"])


def launches(ctx, kind: str):
    """Device activities (kernels, memcpys, memsets) a unit."""
    if ctx["kind"] != kind or not ctx["trace"].spans:
        return None
    return len(ctx["trace"].spans) / ctx["units"]


def scatter_roofline_pct(ctx, kind: str):
    """100 x (sum of the calls' bytes bound / 3.35 TB/s) / the scatter
    kernels' device time."""
    if ctx["kind"] != kind or not ctx.get("scatter_calls"):
        return None
    us = sum(t for name, (t, _) in ctx["trace"].kernels.items()
             if any(k in name for k in SCATTER_KERNELS))
    if us <= 0:
        return None
    bound_s = sum(scatter_bound_bytes(*c) for c in ctx["scatter_calls"]) / PEAK_HBM_BYTES
    return 100.0 * bound_s / (us / 1e6)


def mfu_pct(ctx, kind: str):
    """100 x model FLOPs a unit / (unprofiled wall a unit x 67 TFLOP/s)."""
    if ctx["kind"] != kind or not ctx.get("flops_per_unit"):
        return None
    return 100.0 * ctx["flops_per_unit"] / (ctx["plain_wall_s"] * PEAK_F32_FLOPS)
