"""Chunked eval-time rendering (counterpart of the uniform path of
tensorf_tpu/render/chunked.py::render_chunked).

Rays go through render_rays in chunks under no_grad, with no jitter, at a
uniform sample budget if one is given.  The stratified serving path is not
ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.freq_mask import FreeMasks
from .volume import render_rays


@torch.no_grad()
def render_chunked(
    field,
    alpha_mask,
    rays,
    aabb: torch.Tensor,
    *,
    chunk: int = 8192,
    masks: FreeMasks = FreeMasks(),
    **render_kw,
) -> Tuple[torch.Tensor, torch.Tensor, int, float]:
    """Render (M, 6) rays (numpy or a tensor) in chunks on the field's
    device; returns (rgb (M, 3), depth (M,)) tensors there, the number of
    shaded samples and the largest budget overflow fraction of a chunk.
    ``render_kw`` are render_rays' keywords (step_size, n_samples,
    white_bg, shade_top_k, fused, sample_budget, budget_mode,
    use_coarse_gate)."""
    rays = torch.as_tensor(rays, dtype=torch.float32, device=aabb.device)
    rgbs, depths, n_valid, overflow = [], [], 0, []
    for s in range(0, rays.shape[0], chunk):
        out = render_rays(field, rays[s : s + chunk], masks, aabb=aabb, is_train=False,
                          alpha_mask=alpha_mask, u=None, **render_kw)
        rgbs.append(out.rgb)
        depths.append(out.depth)
        n_valid += out.num_valid_samples
        overflow.append(out.budget_overflow_frac)
    return torch.cat(rgbs), torch.cat(depths), int(n_valid), float(torch.stack(overflow).max())
