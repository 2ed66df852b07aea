"""Volume rendering math: alpha, exclusive transmittance, weights.

Counterpart of tensorf_tpu/ops/render_math.py.  The 1e-10 epsilon sits
inside the cumulative product exactly where the reference puts it — it
matters for gradients through opaque samples.
"""

from __future__ import annotations

from typing import Tuple

import torch


def exclusive_transmittance(alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """T_i = prod_{j<i} (1 - alpha_j + 1e-10) and the final product.

    alpha: (..., N).  Returns (T (..., N), T_final (..., 1)).
    """
    one_minus = 1.0 - alpha + 1e-10
    inclusive = torch.cumprod(one_minus, dim=-1)
    T = torch.cat([torch.ones_like(inclusive[..., :1]), inclusive[..., :-1]], dim=-1)
    return T, inclusive[..., -1:]


def raw2alpha(
    sigma: torch.Tensor, dist: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sigma, dist (..., N) -> (alpha, weights, bg_weight (..., 1))."""
    alpha = 1.0 - torch.exp(-sigma * dist)
    T, bg = exclusive_transmittance(alpha)
    return alpha, alpha * T, bg
