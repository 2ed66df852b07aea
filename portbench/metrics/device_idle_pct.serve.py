"""Share of a served view's wall time in which the device runs nothing.

Layer: serving (eval/evaluation.py RendererHandle, render/chunked.py
render_chunked_stratified). Source: device_trace over one profiled view
against the wall time of one unprofiled view just before. Moves view_ms."""

from portbench.layer_reads import idle_pct


def read(ctx):
    return idle_pct(ctx, "serve")
