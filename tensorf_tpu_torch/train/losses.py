"""Training losses and regularizer weights (counterpart of
tensorf_tpu/train/losses.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LossWeights(NamedTuple):
    ortho: float = 0.0
    l1: float = 0.0
    tv_density: float = 0.0
    tv_app: float = 0.0
    occ: float = 0.0
    occ_range: int = 0
    occ_wb_range: int = 0
    occ_wb_prior: bool = False


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def occlusion_loss(
    sigma: torch.Tensor,
    rgb_gt: Optional[torch.Tensor],
    occ_range: int,
    wb_range: int = 0,
    wb_prior: bool = False,
) -> torch.Tensor:
    """FreeNeRF occlusion regularization: the mean density within the first
    ``occ_range`` samples of each ray; with ``wb_prior``, rays whose ground
    truth is saturated white/black use the wider ``wb_range`` window."""
    n = sigma.shape[-1]
    idx = torch.arange(n, device=sigma.device)
    base = (idx < occ_range).to(sigma.dtype)
    if wb_prior and rgb_gt is not None and wb_range > 0:
        white = torch.all(rgb_gt > 0.99, dim=-1)
        black = torch.all(rgb_gt < 0.01, dim=-1)
        wb = (white | black).to(sigma.dtype)[:, None]
        window = (idx < wb_range).to(sigma.dtype)
        mask = torch.maximum(base[None, :], wb * window[None, :])
    else:
        mask = base[None, :].expand(sigma.shape)
    return torch.sum(sigma * mask) / torch.clamp(torch.sum(mask), min=1.0)
