"""The line-lerp kernels' share of their bytes roofline in the device-bound
training cell, in %.

Layer: kernels (tensorf_tpu_torch/csrc/line_lerp.cu through
ops/line_lerp.py, the float32 line reads of models/tensorf.py::
_sample_line_packed on the card). Source: device_trace for the time of the
kernels named ``line_lerp``; the shapes from the port's ``line`` records of
route 2 in the profiled steps. Every such read in a training step has its
backward, so each counts its forward and backward bytes
(``portbench/line_reads.py``). None where no read took route 2. Moves
train_rays_per_s.device_bound."""

from portbench.line_reads import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train", backward=True)
