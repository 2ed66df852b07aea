"""Idle device time a served view while the host fetches the frame, in ms.

The phase: the frame's read-back and host compositing (tftorch.serve.fetch,
render/chunked.py _SortedFrame.fetch). Layer: serving. Source: device_trace:
the profiled view's idle time that falls inside the phase's spans, as a
share of all of it, times the unprofiled idle time a view (the unprofiled
view's wall less the profiled busy time, as device_idle_pct.serve takes it).
Moves view_ms."""

from portbench.span_reads import phase_idle_ms


def read(ctx):
    return phase_idle_ms(ctx, "serve", "fetch")
