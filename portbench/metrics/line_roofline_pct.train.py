"""The line reads' one-hot GEMMs' share of their roofline in training, in %.

Layer: kernels (models/tensorf.py::_sample_line_packed's one-hot matmul,
ops/grid_sample.py::line_sample_matmul). Source: device_trace for the
GEMM kernels' time; the shapes from the port's ``line`` records
(tensorf_tpu_torch/utils/tracing.py: one (M, L, C, route) a line read in
the profiled steps). Each read that took the matmul (route 1) is two
GEMMs, the forward (M x L) @ (L x C) and the line's gradient
(L x M) @ (M x C); a GEMM's bound is the larger of 2 M L C FLOPs at
67 TFLOP/s (float32; the port keeps TF32 off) and 4 (M L + L C + M C)
bytes at 3.35 TB/s. The sum of the bounds is divided by the device time
of every kernel whose name holds ``gemm``, ``gemv`` or ``splitKreduce``
(cuBLAS's float32 GEMMs: on the H100 cutlass_80_simt_sgemm_* for the
line gradient and sm80_xmma_gemm_f32f32_* for the forward, its
matrix-vector kernels and its split-K reductions). The head and the basis
are the other GEMMs there: 2.6e5 FLOPs a shaded sample (forward and both
backward products) against 5.8e5 a density slot's three line GEMMs and
their gradients, so in cp384.train they add 0.5% of the GEMM FLOPs at
4.4 shaded samples a ray and 1.5% at 14.6, and the share reads that much
low. None when no read took the matmul. Moves train_rays_per_s."""

from portbench.counts import PEAK_F32_FLOPS, PEAK_HBM_BYTES
from portbench.span_reads import port_counts

GEMM_KERNELS = ("gemm", "gemv", "splitkreduce")


def gemm_bound_s(m: int, k: int, n: int) -> float:
    """(m x k) @ (k x n) in float32: the larger of its FLOPs and bytes time."""
    return max(2.0 * m * k * n / PEAK_F32_FLOPS, 4.0 * (m * k + k * n + m * n) / PEAK_HBM_BYTES)


def read(ctx):
    if ctx["kind"] != "train":
        return None
    counts = port_counts(ctx)
    reads = [r for r in (counts or {}).get("line", []) if r[3] == 1]
    if not reads:
        return None
    us = sum(t for name, (t, _) in ctx["trace"].kernels.items()
             if any(k in name.lower() for k in GEMM_KERNELS))
    if us <= 0:
        return None
    bound = sum(gemm_bound_s(m, L, c) + gemm_bound_s(L, m, c) for m, L, c, _ in reads)
    return 100.0 * bound / (us / 1e6)
