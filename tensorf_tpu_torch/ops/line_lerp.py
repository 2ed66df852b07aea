"""Linear line sampling by its two texels: ``out[m] = (1 - w) line[i0] +
w line[i0 + 1]`` and its backward into the line.

On a CUDA tensor ``line_lerp`` launches the hand-written kernels in
``csrc/line_lerp.cu`` (or raises): the lerp forward, and in the backward the
line's gradient summed in shared memory.  They take the float32 reads that
``ops/grid_sample.py::line_sample_matmul`` does by an (M, L) one-hot matrix
on the CPU (models/tensorf.py routes them).  On a CPU tensor ``line_lerp``
runs ``line_lerp_reference``, the plain version with the same weights,
which the tests and the on-card checks hold the kernel against.  There is
no fallback from the kernel to the plain version.

The weights are the one-hot's: ``pos = (clamp(c, -1, 1) + 1) * 0.5 *
(L - 1)``, ``i0 = floor(pos)``, ``w = pos - i0``, each step rounded to
float32; the upper tap of ``pos = L - 1`` has weight 0 and is not read.  A
coordinate that is not finite reads a zero row and gives the line no
gradient.  There alone the one-hot differs: it clamps +-inf to the end
texel (NaN matches no column there either), as the JAX package's does.  No
path of the port makes a coordinate that is not finite.  Coordinates carry
no gradient (the reference detaches them).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_library

KERNEL_NAME = "line_lerp"
KERNEL_SOURCE = "tensorf_tpu_torch/csrc/line_lerp.cu"
# the backward keeps an (L, slice) float32 slice of the gradient in shared
# memory: the longest line it takes (the kernel's kSmemBudget / 4)
MAX_LEN = 96 * 1024 // 4


def _taps(line: torch.Tensor, coord: torch.Tensor):
    """(i0 int64, w0, w1): the taps of each coordinate; rows that are not
    finite have weights 0."""
    L = line.shape[0]
    ok = torch.isfinite(coord)
    pos = (torch.clamp(coord, -1.0, 1.0) + 1.0) * 0.5 * (L - 1)
    f = torch.floor(torch.where(ok, pos, torch.zeros_like(pos)))
    w1 = torch.where(ok, pos - f, torch.zeros_like(pos))
    w0 = torch.where(ok, 1.0 - w1, torch.zeros_like(pos))
    return f.long(), w0, w1


def line_lerp_reference(line: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Plain version: the two texels gathered and lerped; differentiable in
    ``line`` through autograd.  line (L, C), coord (...,) -> (..., C)."""
    L, C = line.shape
    c = coord.reshape(-1).detach()
    i0, w0, w1 = _taps(line, c)
    i1 = torch.clamp(i0 + 1, max=L - 1)
    w1 = torch.where(i0 + 1 < L, w1, torch.zeros_like(w1))
    out = w0[:, None] * line.index_select(0, i0) + w1[:, None] * line.index_select(0, i1)
    return out.reshape(*coord.shape, C)


def _check(line: torch.Tensor, coord: torch.Tensor) -> None:
    if line.dtype != torch.float32 or line.dim() != 2:
        raise ValueError(f"line_lerp: line must be a 2-D float32 tensor, got {line.dtype} "
                         f"of shape {tuple(line.shape)}")
    if coord.dtype != torch.float32:
        raise ValueError(f"line_lerp: coord must be float32, got {coord.dtype}")
    if coord.device != line.device:
        raise ValueError(f"line_lerp: coord on {coord.device} but line on {line.device}")
    if line.device.type not in ("cpu", "cuda"):
        raise ValueError(f"line_lerp: unsupported device {line.device}")
    L, C = line.shape
    if L < 1 or C < 1:
        raise ValueError(f"line_lerp: empty line of shape {tuple(line.shape)}")
    if line.device.type == "cuda" and L > MAX_LEN:
        raise ValueError(f"line_lerp: a line of {L} texels is longer than the kernel's "
                         f"{MAX_LEN}")


_fns = {}  # the C entry points, bound at first use


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = load_library(KERNEL_NAME)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for entry in ("tftorch_line_lerp_f32", "tftorch_line_lerp_grad_f32"):
            f = getattr(lib, entry)
            f.argtypes, f.restype = [p, p, ll, p, ll, i, i, p], ctypes.c_int
            _fns[entry] = f
        fn = _fns[name]
    return fn


def _stream(device: torch.device) -> int:
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # which costs more host time than a small launch itself
    return torch._C._cuda_getCurrentRawStream(device.index)


def _forward(line: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """The forward kernel; coord 1-D (any stride), line contiguous."""
    L, C = line.shape
    M = coord.shape[0]
    out = torch.empty((M, C), dtype=torch.float32, device=line.device)
    if M == 0:
        return out
    err = _kernel("tftorch_line_lerp_f32")(
        line.data_ptr(), coord.data_ptr(), coord.stride(0), out.data_ptr(), M, L, C,
        _stream(line.device))
    if err != 0:
        raise RuntimeError(f"line_lerp: forward launch failed with CUDA error {err}")
    line_lerp.launches += 1
    return out


def _backward(g: torch.Tensor, coord: torch.Tensor, L: int) -> torch.Tensor:
    """The backward kernels (a zero fill, then the sums): the (L, C)
    gradient of the line from g (M, C)."""
    M, C = g.shape
    if M == 0:
        return torch.zeros((L, C), dtype=torch.float32, device=g.device)
    d_line = torch.empty((L, C), dtype=torch.float32, device=g.device)
    err = _kernel("tftorch_line_lerp_grad_f32")(
        g.data_ptr(), coord.data_ptr(), coord.stride(0), d_line.data_ptr(), M, L, C,
        _stream(g.device))
    if err != 0:
        raise RuntimeError(f"line_lerp: backward launch failed with CUDA error {err}")
    line_lerp.launches += 1
    return d_line


class _LineLerp(torch.autograd.Function):
    """out = lerp(line, coord) by the kernel; backward: the line's gradient
    by the kernel.  Saves the coordinates (a view of them), no matrix."""

    @staticmethod
    def forward(ctx, line: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(coord)
        ctx.n_texels = line.shape[0]
        return _forward(line, coord)

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        (coord,) = ctx.saved_tensors
        return _backward(d_out.contiguous(), coord, ctx.n_texels), None


def line_lerp(line: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Sample the (L, C) float32 ``line`` at ``coord`` (...,) in [-1, 1]
    -> (..., C).  CUDA: the kernels; CPU: ``line_lerp_reference``.

    ``line_lerp.launches`` counts the CUDA calls that launched the kernels:
    one a forward and one a backward (whose call enqueues two grids, the
    gradient's zero fill and its sums).  The coordinate is read in place where it
    is a strided view (the k-th column of an (M, 3) xyz).
    """
    _check(line, coord)
    if line.device.type == "cpu":
        return line_lerp_reference(line, coord)
    c = coord.detach().reshape(-1)  # a view where the strides allow one
    with torch.cuda.device(line.device):
        out = _LineLerp.apply(line.contiguous(), c)
    return out.reshape(*coord.shape, line.shape[1])


line_lerp.launches = 0
