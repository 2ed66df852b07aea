"""Share of a training step's wall time in which the device runs nothing.

Layer: train step (train/step.py, driven as train/loop.py drives it).
Source: device_trace: the union of the profiled steps' kernel, memcpy and
memset intervals, against the wall time of the unprofiled steps just before
them (the profiler slows the host). Moves train_rays_per_s.device_bound."""

from portbench.layer_reads import idle_pct


def read(ctx):
    return idle_pct(ctx, "train")
