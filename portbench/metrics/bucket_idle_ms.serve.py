"""Idle device time a served view while the host renders buckets, in ms.

The phase: each bucket chunk's render (tftorch.serve.bucket,
render/chunked.py). Layer: serving. Source: device_trace: the profiled
view's idle time that falls inside the phase's spans, as a share of all of
it, times the unprofiled idle time a view (the unprofiled view's wall less
the profiled busy time, as device_idle_pct.serve takes it). Moves view_ms."""

from portbench.span_reads import phase_idle_ms


def read(ctx):
    return phase_idle_ms(ctx, "serve", "bucket")
