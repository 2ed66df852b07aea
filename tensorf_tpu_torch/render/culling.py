"""Ray pre-filtering (counterpart of the bbox part of
tensorf_tpu/render/culling.py).  Alpha-mask culling and ray
stratification are not ported yet."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.rays import aabb_entry_exit


def _bbox_hit(rays: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    t_min, t_max = aabb_entry_exit(rays[:, :3], rays[:, 3:6], aabb)
    return t_max > t_min


def filter_rays_bbox(
    all_rays, all_rgbs, aabb, device, chunk: int = 51200
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep rays whose line intersects the scene bbox (reference
    filtering_rays bbox_only=True).  Returns the kept rays and colors as
    tensors on ``device`` — the device-resident ray store."""
    rays = torch.as_tensor(np.asarray(all_rays, np.float32), device=device)
    rgbs = torch.as_tensor(np.asarray(all_rgbs, np.float32), device=device)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=device)
    mask = torch.cat(
        [_bbox_hit(rays[s : s + chunk], aabb_t) for s in range(0, rays.shape[0], chunk)]
    )
    kept = int(mask.sum())
    print(
        f"========> bbox ray filtering: kept {kept}/{mask.numel()} "
        f"({kept / max(mask.numel(), 1):.3f})"
    )
    return rays[mask], rgbs[mask]
