"""Bilinear / linear factor sampling (counterpart of
tensorf_tpu/ops/grid_sample.py).

Channels-last layout: planes are ``(H, W, C)`` and lines ``(L, C)``, so each
gathered tap reads a contiguous channel vector.  Every row gather of a
plane or footprint table goes through ``gather_rows``, an autograd Function
whose backward is the hand-written row scatter-add (ops/scatter_add.py).
The footprint build stays plain torch (pad + cat), so autograd folds the
tap gradients back onto the plane as the JAX transpose does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .scatter_add import scatter_add


class _GatherRows(torch.autograd.Function):
    """rows = table[idx]; backward: d_table = scatter_add(idx, d_rows).

    A bfloat16 table (a model whose ``grid_dtype`` is bfloat16) gathers
    bf16 rows, and its row gradients arrive in bf16; the scatter-add's
    bf16 entry point sums them in float32, and that sum is rounded to
    bf16 once, here, because autograd gives a table the gradient of its own
    dtype.  The JAX package sums them in bf16 (the transpose of its bf16
    gather), so the two differ by bf16 rounding.
    """

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, d_rows: torch.Tensor):
        (idx,) = ctx.saved_tensors
        d_table = scatter_add(idx, d_rows.contiguous(), ctx.n_rows)
        return d_table.to(ctx.table_dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (n_rows, C) float32 or bfloat16, idx (M,) int32 in range ->
    (M, C) of the table's dtype."""
    return _GatherRows.apply(table, idx)


def _tap_lerp(w: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Contract (M, T) tap weights with (M, T, C) gathered taps -> (M, C).

    A left-to-right add chain, in the same order as the JAX version.
    """
    out = w[:, 0, None] * taps[:, 0]
    for t in range(1, taps.shape[1]):
        out = out + w[:, t, None] * taps[:, t]
    return out


def _tap_1d(coord: torch.Tensor, size: int):
    """align_corners=True unnormalization + floor taps for one axis.

    Returns (i0, i1, w1, inb0, inb1): clipped int32 taps, the lerp weight of
    the upper tap, and in-bounds indicators implementing zeros padding.
    """
    x = (coord + 1.0) * 0.5 * (size - 1)
    x0f = torch.floor(x)
    w1 = x - x0f
    i0 = x0f.to(torch.int32)
    i1 = i0 + 1
    inb0 = ((i0 >= 0) & (i0 < size)).to(coord.dtype)
    inb1 = ((i1 >= 0) & (i1 < size)).to(coord.dtype)
    return i0.clamp(0, size - 1), i1.clamp(0, size - 1), w1, inb0, inb1


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a channels-last plane (H, W, C) at coords (..., 2)
    in [-1, 1]; ``coords[..., 0]`` indexes W and ``[..., 1]`` H
    (align_corners=True, zeros padding).  Returns (..., C)."""
    H, W, C = plane.shape
    shape = coords.shape[:-1]
    coords = coords.reshape(-1, 2)
    x0, x1, wx, bx0, bx1 = _tap_1d(coords[:, 0], W)
    y0, y1, wy, by0, by1 = _tap_1d(coords[:, 1], H)
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], dim=-1)
    w = torch.stack(
        [
            (1 - wy) * (1 - wx) * by0 * bx0,
            (1 - wy) * wx * by0 * bx1,
            wy * (1 - wx) * by1 * bx0,
            wy * wx * by1 * bx1,
        ],
        dim=-1,
    )
    taps = gather_rows(plane.reshape(H * W, C), idx.reshape(-1)).reshape(-1, 4, C)
    return _tap_lerp(w, taps).reshape(*shape, C)


def grid_sample_1d(line: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Linear sample of a channels-last line (L, C) at coord (...,) in
    [-1, 1] with zeros padding.  Returns (..., C)."""
    L, C = line.shape
    shape = coord.shape
    i0, i1, w1, b0, b1 = _tap_1d(coord.reshape(-1), L)
    idx = torch.stack([i0, i1], dim=-1)
    w = torch.stack([(1 - w1) * b0, w1 * b1], dim=-1)
    taps = gather_rows(line, idx.reshape(-1)).reshape(-1, 2, C)
    return _tap_lerp(w, taps).reshape(*shape, C)


def make_footprint_2d(plane: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, 4C), each row holding its 2x2 neighborhood.

    Rows at y=H-1 / x=W-1 zero-pad the out-of-range taps; in-range
    align_corners coordinates give those taps zero lerp weight.
    """
    H, W, _ = plane.shape
    p = F.pad(plane, (0, 0, 0, 1, 0, 1))
    return torch.cat(
        [p[:H, :W], p[:H, 1 : W + 1], p[1 : H + 1, :W], p[1 : H + 1, 1 : W + 1]],
        dim=-1,
    )


def make_footprint_1d(line: torch.Tensor) -> torch.Tensor:
    """(L, C) -> (L, 2C), each row holding texels (l, l+1); the last row's
    upper tap is zero (an in-range coordinate gives it weight 0)."""
    L, _ = line.shape
    p = F.pad(line, (0, 0, 0, 1))
    return torch.cat([p[:L], p[1 : L + 1]], dim=-1)


def footprint_sample_2d(
    fp: torch.Tensor, H: int, W: int, coords: torch.Tensor
) -> torch.Tensor:
    """Bilinear sample from a footprint table; one gathered row per point.

    fp: (H, W, 4C) from make_footprint_2d; coords (..., 2) as in
    grid_sample_2d.  Returns (..., C), equal to grid_sample_2d(plane,
    coords) for coords in [-1, 1].  Out-of-range coords clamp to the edge
    (not torch's zeros padding): callers mask those samples out
    downstream, which is the renderer's contract for invalid samples.
    """
    C4 = fp.shape[-1]
    C = C4 // 4
    shape = coords.shape[:-1]
    coords = torch.clamp(coords.reshape(-1, 2), -1.0, 1.0)
    x = (coords[:, 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (H - 1)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    idx = y0f.to(torch.int32) * W + x0f.to(torch.int32)
    taps = gather_rows(fp.reshape(H * W, C4), idx).reshape(-1, 4, C)
    w = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx], dim=-1)
    return _tap_lerp(w, taps).reshape(*shape, C)


def footprint_sample_1d(fp: torch.Tensor, L: int, coord: torch.Tensor) -> torch.Tensor:
    """Linear sample from a 1-D footprint table (L, 2C); one gathered row
    per point, whose backward is the row scatter-add.  Same edge-clamp
    contract as footprint_sample_2d.  Returns (..., C)."""
    C = fp.shape[-1] // 2
    shape = coord.shape
    coord = torch.clamp(coord.reshape(-1), -1.0, 1.0)
    pos = (coord + 1.0) * 0.5 * (L - 1)
    i0f = torch.floor(pos)
    w1 = pos - i0f
    taps = gather_rows(fp, i0f.to(torch.int32)).reshape(-1, 2, C)
    w = torch.stack([1 - w1, w1], dim=-1)
    return _tap_lerp(w, taps).reshape(*shape, C)


class _MatmulF32(torch.autograd.Function):
    """out = a @ b in float32 from bfloat16 operands: JAX's
    ``einsum(..., preferred_element_type=jnp.float32)``.

    A product of two bf16 values is exact in float32, so widening both
    operands and multiplying in float32 gives what a bf16 matmul with a
    float32 result gives, on the CPU and the card alike (torch's bf16
    ``matmul`` rounds its result to bf16, and its ``mm(..., out_dtype=)``
    has no CPU kernel).  ``a`` carries no gradient (the one-hot of detached
    coordinates) and is kept for the backward in bf16; the widened copies
    live only inside each call.
    """

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a)
        ctx.b_dtype = b.dtype
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        (a,) = ctx.saved_tensors
        # summed in float32, rounded to b's dtype once (JAX's transpose
        # rounds its float32 result to the operand's dtype too)
        return None, (a.float().T @ d_out).to(ctx.b_dtype)


def line_sample_matmul(line: torch.Tensor, coord: torch.Tensor, a_dtype=None) -> torch.Tensor:
    """Linear line sampling as a dense one-hot-lerp matmul (M, L) @ (L, C).

    Same edge-clamp contract as footprint_sample_2d; coords carry no
    gradient (the reference detaches them).  Its backward is the transposed
    matmul, so lines need no scatter.

    ``a_dtype`` (None or torch.bfloat16) sets the one-hot matrix's dtype:
    the matrix and the line are cast to it and the product comes out in
    float32, as the JAX package computes it (``preferred_element_type``).
    Each row's two weights round to bf16 one by one, as JAX's cast of the
    float32 matrix rounds them, so the matrix is built in that dtype.
    """
    L, C = line.shape
    shape = coord.shape
    coord = torch.clamp(coord.reshape(-1), -1.0, 1.0).detach()
    pos = (coord + 1.0) * 0.5 * (L - 1)
    i0 = torch.floor(pos)
    w1 = pos - i0
    cols = torch.arange(L, dtype=pos.dtype, device=pos.device)[None, :]
    dt = pos.dtype if a_dtype is None else a_dtype
    zero = torch.zeros((), dtype=dt, device=pos.device)
    # the two taps' columns differ, so the sum adds a weight to a zero: exact
    a = torch.where(cols == i0[:, None], (1.0 - w1[:, None]).to(dt), zero) + torch.where(
        cols == i0[:, None] + 1.0, w1[:, None].to(dt), zero
    )
    if a_dtype is None:
        return (a @ line).reshape(*shape, C)
    return _MatmulF32.apply(a, line.to(a_dtype)).reshape(*shape, C)


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a single-channel (D, H, W) volume at coords
    (..., 3) in [-1, 1]; ``coords[..., 0]`` indexes W, ``[..., 1]`` H and
    ``[..., 2]`` D (align_corners=True, zeros padding).  Returns (...,).
    The alpha mask's lookup: no gradient flows to the volume."""
    D, H, W = volume.shape
    shape = coords.shape[:-1]
    coords = coords.reshape(-1, 3)
    x0, x1, wx, bx0, bx1 = _tap_1d(coords[:, 0], W)
    y0, y1, wy, by0, by1 = _tap_1d(coords[:, 1], H)
    z0, z1, wz, bz0, bz1 = _tap_1d(coords[:, 2], D)
    flat = volume.reshape(-1)

    def tap(zi, yi, xi, wzt, wyt, wxt):
        v = flat[(zi * (H * W) + yi * W + xi).long()]
        return v * (wzt * wyt * wxt)

    out = (
        tap(z0, y0, x0, (1 - wz) * bz0, (1 - wy) * by0, (1 - wx) * bx0)
        + tap(z0, y0, x1, (1 - wz) * bz0, (1 - wy) * by0, wx * bx1)
        + tap(z0, y1, x0, (1 - wz) * bz0, wy * by1, (1 - wx) * bx0)
        + tap(z0, y1, x1, (1 - wz) * bz0, wy * by1, wx * bx1)
        + tap(z1, y0, x0, wz * bz1, (1 - wy) * by0, (1 - wx) * bx0)
        + tap(z1, y0, x1, wz * bz1, (1 - wy) * by0, wx * bx1)
        + tap(z1, y1, x0, wz * bz1, wy * by1, (1 - wx) * bx0)
        + tap(z1, y1, x1, wz * bz1, wy * by1, wx * bx1)
    )
    return out.reshape(shape)
