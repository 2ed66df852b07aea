"""Row scatter-add ``out[idx[m]] += g[m]`` — the plane-gather backward.

Counterpart of the TPU kernel tensorf_tpu/ops/pallas/scatter_add2.py::
scatter_add_banked.  On a CUDA tensor ``scatter_add`` launches the
hand-written kernel in ``csrc/scatter_add.cu`` (or raises); on a CPU tensor
it runs ``scatter_add_reference``, the plain PyTorch version the tests and
the on-card checks hold the kernel against.  There is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_library

KERNEL_NAME = "scatter_add"
KERNEL_SOURCE = "tensorf_tpu_torch/csrc/scatter_add.cu"


def scatter_add_reference(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain version: fp32 ``index_add_`` into a zeroed (n_rows, C) table."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, idx, g.to(torch.float32))


def _check(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(
            f"scatter_add: idx must be a contiguous 1-D int32 tensor, got "
            f"{idx.dtype} of shape {tuple(idx.shape)}"
        )
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(
            f"scatter_add: g must be a contiguous 2-D float32 tensor, got "
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


_fn = None  # the C entry point, bound at first use


def _kernel():
    global _fn
    if _fn is None:
        fn = load_library(KERNEL_NAME).tftorch_scatter_add_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def scatter_add(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """out[idx[m]] += g[m]; idx (M,) int32 in [0, n_rows), g (M, C) float32
    -> (n_rows, C) float32.

    ``scatter_add.launches`` counts the calls that launched the kernel (CUDA
    tensors only); each such call enqueues two grids, the zero fill and the
    scatter.
    """
    _check(idx, g, n_rows)
    if g.device.type == "cpu":
        return scatter_add_reference(idx, g, n_rows)
    M, C = g.shape
    if M == 0 or C == 0:
        return torch.zeros((n_rows, C), dtype=torch.float32, device=g.device)
    device = g.device.index
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return scatter_add(idx, g, n_rows)
    fn = _kernel()
    # the entry point zero-fills ``out`` on the stream it launches on
    out = g.new_empty((n_rows, C))
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # which costs more host time than the small launches themselves
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = fn(idx.data_ptr(), g.data_ptr(), out.data_ptr(), M, int(n_rows), C, stream)
    if err != 0:
        raise RuntimeError(f"scatter_add: kernel launch failed with CUDA error {err}")
    scatter_add.launches += 1
    return out


scatter_add.launches = 0
