"""Row scatter-add ``out[idx[m]] += g[m]`` — the plane-gather backward.

Counterpart of the TPU kernel tensorf_tpu/ops/pallas/scatter_add2.py::
scatter_add_banked, which takes ``g`` of any float type and sums in
float32.  On a CUDA tensor ``scatter_add`` launches the hand-written kernel
in ``csrc/scatter_add.cu`` (or raises): its float32 entry point for a
float32 ``g``, its bfloat16 entry point (which reads the bf16 values and
sums them in float32) for a bfloat16 ``g``, the tap gradients of a model
whose ``grid_dtype`` is bfloat16.  On a CPU tensor it runs
``scatter_add_reference``, the plain PyTorch version the tests and the
on-card checks hold the kernel against.  There is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from ..utils.cuda_build import load_library

KERNEL_NAME = "scatter_add"
KERNEL_SOURCE = "tensorf_tpu_torch/csrc/scatter_add.cu"
# the C entry point of each dtype of g
_ENTRY = {torch.float32: "tftorch_scatter_add_f32", torch.bfloat16: "tftorch_scatter_add_bf16"}


def scatter_add_reference(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain version: fp32 ``index_add_`` of ``g.float()`` into a zeroed
    (n_rows, C) table."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, idx, g.to(torch.float32))


def _check(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(
            f"scatter_add: idx must be a contiguous 1-D int32 tensor, got "
            f"{idx.dtype} of shape {tuple(idx.shape)}"
        )
    if g.dtype not in _ENTRY or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(
            f"scatter_add: g must be a contiguous 2-D float32 or bfloat16 tensor, got "
            f"{g.dtype} of shape {tuple(g.shape)}"
        )
    if idx.shape[0] != g.shape[0]:
        raise ValueError(
            f"scatter_add: idx has {idx.shape[0]} rows but g has {g.shape[0]}"
        )
    if idx.device != g.device:
        raise ValueError(f"scatter_add: idx on {idx.device} but g on {g.device}")
    if int(n_rows) <= 0:
        raise ValueError(f"scatter_add: n_rows must be positive, got {n_rows}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scatter_add: unsupported device {g.device}")


_fns = {}  # the C entry points by dtype of g, bound at first use


def _kernel(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(load_library(KERNEL_NAME), _ENTRY[dtype])
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def scatter_add(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """out[idx[m]] += g[m]; idx (M,) int32 in [0, n_rows), g (M, C) float32
    or bfloat16 -> (n_rows, C) float32.

    ``scatter_add.launches`` counts the calls that launched the kernel (CUDA
    tensors only), through either entry point, and
    ``scatter_add_bf16.launches`` those through the bfloat16 one; each such
    call enqueues two grids, the zero fill and the scatter.  While a
    profiler runs, every call (CPU or CUDA) appends its ``(M, C, bytes of
    an element of g, n_rows)`` to the ``scatter_add`` shapes of
    utils/tracing.py.
    """
    _check(idx, g, n_rows)
    if tracing.enabled():
        tracing.count_shape("scatter_add", (int(idx.shape[0]), int(g.shape[1]),
                                            g.element_size(), int(n_rows)))
    if g.device.type == "cpu":
        return scatter_add_reference(idx, g, n_rows)
    M, C = g.shape
    if M == 0 or C == 0:
        return torch.zeros((n_rows, C), dtype=torch.float32, device=g.device)
    device = g.device.index
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(idx, g, n_rows, device)
    return _launch(idx, g, n_rows, device)


def _launch(idx: torch.Tensor, g: torch.Tensor, n_rows: int, device: int) -> torch.Tensor:
    """The kernel on ``device``, the current CUDA device; ``g`` not empty."""
    M, C = g.shape
    fn = _kernel(g.dtype)
    # the entry point zero-fills ``out`` on the stream it launches on
    out = torch.empty((n_rows, C), dtype=torch.float32, device=g.device)
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # which costs more host time than the small launches themselves
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = fn(idx.data_ptr(), g.data_ptr(), out.data_ptr(), M, int(n_rows), C, stream)
    if err != 0:
        raise RuntimeError(f"scatter_add: kernel launch failed with CUDA error {err}")
    scatter_add.launches += 1
    if g.dtype == torch.bfloat16:
        scatter_add_bf16.launches += 1
    return out


def scatter_add_bf16(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``scatter_add`` of a bfloat16 ``g`` alone (its bfloat16 entry point
    on a CUDA tensor); raises on another dtype."""
    if g.dtype != torch.bfloat16:
        raise ValueError(f"scatter_add_bf16: g must be bfloat16, got {g.dtype}")
    return scatter_add(idx, g, n_rows)


scatter_add.launches = 0
scatter_add_bf16.launches = 0
