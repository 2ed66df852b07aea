"""Idle device time a training step while the host runs the optimizer, in ms.

The phase: zero_grad and the Adam step (tftorch.train.optim, train/step.py).
Layer: train step. Source: device_trace: the profiled steps' idle time (the
gaps between their kernel, memcpy and memset intervals) that falls inside
the phase's spans, as a share of all of it, times the unprofiled idle time a
step (the unprofiled wall a step less the profiled busy time a step, as
device_idle_pct.train takes it). Moves train_rays_per_s."""

from portbench.span_reads import phase_idle_ms


def read(ctx):
    return phase_idle_ms(ctx, "train", "optim")
