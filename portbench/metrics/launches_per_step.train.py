"""Device activities (kernels, memcpys, memsets) a training step enqueues; a
host-bound step pays for each.

Layer: train step. Source: device_trace: the profiled steps' device
activities over their count. Moves train_rays_per_s."""

from portbench.layer_reads import launches


def read(ctx):
    return launches(ctx, "train")
