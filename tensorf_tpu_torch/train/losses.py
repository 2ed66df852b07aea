"""Training losses and regularizer weights (counterpart of
tensorf_tpu/train/losses.py).

On several ranks each rank's data terms are its share of the global
term: ``count`` and ``denom`` give the global normalisers (the batch's
values and the occlusion mask's global sum), so the ranks' terms sum to
the one-rank term."""

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


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             count: Optional[float] = None) -> torch.Tensor:
    """The mean squared error; with ``count``, the sum of squared errors
    over ``count`` (a rank's share of the global batch's mean)."""
    if count is None:
        return torch.mean(torch.square(pred - target))
    return torch.sum(torch.square(pred - target)) / count


def occlusion_mask(
    sigma: torch.Tensor,
    rgb_gt: Optional[torch.Tensor],
    occ_range: int,
    wb_range: int = 0,
    wb_prior: bool = False,
) -> torch.Tensor:
    """The occlusion window of each ray's samples, shaped like ``sigma``:
    the first ``occ_range`` samples; with ``wb_prior``, the first
    ``wb_range`` of a ray whose ground truth is saturated white/black."""
    n = sigma.shape[-1]
    idx = torch.arange(n, device=sigma.device)
    base = (idx < occ_range).to(sigma.dtype)
    if wb_prior and rgb_gt is not None and wb_range > 0:
        white = torch.all(rgb_gt > 0.99, dim=-1)
        black = torch.all(rgb_gt < 0.01, dim=-1)
        wb = (white | black).to(sigma.dtype)[:, None]
        window = (idx < wb_range).to(sigma.dtype)
        return torch.maximum(base[None, :], wb * window[None, :])
    return base[None, :].expand(sigma.shape)


def occlusion_loss(
    sigma: torch.Tensor,
    rgb_gt: Optional[torch.Tensor],
    occ_range: int,
    wb_range: int = 0,
    wb_prior: bool = False,
    denom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FreeNeRF occlusion regularization: the mean density within each
    ray's occlusion window (``occlusion_mask``).  ``denom``: the mask's sum
    over every rank's rays, in place of this rank's own."""
    mask = occlusion_mask(sigma, rgb_gt, occ_range, wb_range, wb_prior)
    if denom is None:
        denom = torch.sum(mask)
    return torch.sum(sigma * mask) / torch.clamp(denom, min=1.0)
