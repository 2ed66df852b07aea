"""The whole training step's share of the card's float32 peak.

Layer: whole step. Source: host_clock: the model FLOPs of a profiled step
(portbench/counts.py over the samples the plain reference finds alive and
shaded along its rays) over the unprofiled step's wall time x 67 TFLOP/s,
the H100 SXM's float32 peak (the port keeps TF32 off). Moves
train_rays_per_s."""

from portbench.layer_reads import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train")
