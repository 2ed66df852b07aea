"""The scatter-add kernel's share of its bytes roofline in training.

Layer: kernels (csrc/scatter_add.cu through ops/scatter_add.py). Source:
device_trace for the fill and scatter grids' time; the bound M*C*s + M*4 +
n_rows*C*4 bytes over 3.35 TB/s from each call's shapes, recorded around the
port's calls in the profiled steps. Moves train_rays_per_s."""

from portbench.layer_reads import scatter_roofline_pct


def read(ctx):
    return scatter_roofline_pct(ctx, "train")
