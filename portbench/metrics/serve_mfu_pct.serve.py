"""A served view's share of the card's float32 peak.

Layer: serving. Source: host_clock: the view's forward FLOPs
(portbench/counts.py over the samples the plain reference finds alive and
shaded along its rays) over the unprofiled view's wall time x 67 TFLOP/s.
Moves view_ms."""

from portbench.layer_reads import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "serve")
