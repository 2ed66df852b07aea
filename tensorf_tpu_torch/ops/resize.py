"""align_corners linear resizing for the voxel-upsampling events
(counterpart of tensorf_tpu/ops/resize.py).

Output index i maps to source coordinate i*(S-1)/(T-1) and lerps between
its two neighbours, axis by axis — what ``F.interpolate(mode='bilinear',
align_corners=True)`` computes, on the channels-last layout.  Runs once
per schedule event, so it is plain torch.
"""

from __future__ import annotations

import torch


def _axis_resize(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    src = x.shape[axis]
    if src == target:
        return x
    if src == 1:
        reps = [1] * x.dim()
        reps[axis] = target
        return x.repeat(*reps)
    pos = torch.arange(target, dtype=torch.float32, device=x.device) * ((src - 1) / (target - 1))
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=src - 1)
    w = (pos - i0.to(torch.float32)).to(x.dtype)
    lo = torch.index_select(x, axis, i0)
    hi = torch.index_select(x, axis, i1)
    shape = [1] * x.dim()
    shape[axis] = target
    w = w.reshape(shape)
    return lo * (1 - w) + hi * w


def resize_bilinear_align_corners(plane: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """(H, W, C) -> (target_h, target_w, C), separable align_corners lerp."""
    return _axis_resize(_axis_resize(plane, 0, target_h), 1, target_w)


def resize_linear_align_corners(line: torch.Tensor, target_l: int) -> torch.Tensor:
    """(L, C) -> (target_l, C)."""
    return _axis_resize(line, 0, target_l)
