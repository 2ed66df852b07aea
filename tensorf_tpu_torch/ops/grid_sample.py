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
    """rows = table[idx]; backward: d_table = scatter_add(idx, d_rows)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, d_rows: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return scatter_add(idx, d_rows.contiguous(), ctx.n_rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (n_rows, C) float32, idx (M,) int32 in range -> (M, C)."""
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


def line_sample_matmul(line: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Linear line sampling as a dense one-hot-lerp matmul (M, L) @ (L, C).

    Same edge-clamp contract as footprint_sample_2d; coords carry no
    gradient (the reference detaches them).  Its backward is the transposed
    matmul, so lines need no scatter.
    """
    L, C = line.shape
    shape = coord.shape
    coord = torch.clamp(coord.reshape(-1), -1.0, 1.0).detach()
    pos = (coord + 1.0) * 0.5 * (L - 1)
    i0 = torch.floor(pos)
    w1 = pos - i0
    cols = torch.arange(L, dtype=pos.dtype, device=pos.device)[None, :]
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    a = torch.where(cols == i0[:, None], 1.0 - w1[:, None], zero) + torch.where(
        cols == i0[:, None] + 1.0, w1[:, None], zero
    )
    return (a @ line).reshape(*shape, C)
