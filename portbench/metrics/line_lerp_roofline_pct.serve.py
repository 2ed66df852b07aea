"""The line-lerp kernel's share of its bytes roofline in serving, in %.

Layer: kernels (tensorf_tpu_torch/csrc/line_lerp.cu's forward through
ops/line_lerp.py, the float32 line reads of models/tensorf.py::
_sample_line_packed on the card). Source: device_trace for the time of the
kernels named ``line_lerp``; the shapes from the port's ``line`` records of
route 2 in the profiled view, each its forward bytes alone (a view runs no
backward; ``portbench/line_reads.py``). None where no read took route 2.
Moves view_ms."""

from portbench.line_reads import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "serve", backward=False)
