"""The line-lerp kernels' share of their bytes roofline (``metrics/
line_lerp_roofline_pct.*.py``).

The port records each line read's ``(M, L, C, route)`` as ``line`` while a
profiler runs (tensorf_tpu_torch/utils/tracing.py); route 2 is a read by
the line-lerp kernels (tensorf_tpu_torch/csrc/line_lerp.cu).  A read's
bytes bound: the forward reads M coordinates and the (L, C) line and writes
the (M, C) rows, M*4 + L*C*4 + M*C*4 bytes; the backward reads the
coordinates and the (M, C) gradient rows and writes the (L, C) gradient,
M*4 + M*C*4 + L*C*4 bytes.  Their operations, 3*M*C and 4*M*C, never bound
them: under one FLOP a byte, against the H100's 20 FLOP/B float32 ridge.
The sum of the bounds over 3.35 TB/s is divided by the device time of every
kernel whose name holds ``line_lerp`` (the forward, and the backward's
zero fill and sums).  A program without route-2 records gives
nothing to read: None.
"""

from __future__ import annotations

from typing import Optional

from .counts import PEAK_HBM_BYTES
from .span_reads import port_counts

KERNELS = "line_lerp"


def forward_bytes(m: int, L: int, c: int) -> int:
    return 4 * (m + L * c + m * c)


def backward_bytes(m: int, L: int, c: int) -> int:
    return 4 * (m + m * c + L * c)


def roofline_pct(ctx, kind: str, backward: bool) -> Optional[float]:
    """100 x the route-2 reads' bytes bound / the line-lerp kernels' time;
    ``backward``: every read had its backward too (training)."""
    if ctx["kind"] != kind:
        return None
    reads = [r for r in (port_counts(ctx) or {}).get("line", []) if r[3] == 2]
    if not reads:
        return None
    us = sum(t for name, (t, _) in ctx["trace"].kernels.items() if KERNELS in name)
    if us <= 0:
        return None
    nbytes = sum(forward_bytes(m, L, c) + (backward_bytes(m, L, c) if backward else 0)
                 for m, L, c, _ in reads)
    return 100.0 * nbytes / PEAK_HBM_BYTES / (us / 1e6)
