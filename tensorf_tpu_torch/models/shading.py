"""Shading head: the MLP_Fea branch (counterpart of
tensorf_tpu/models/shading.py).

Weights keep the JAX layout, ``w (in, out)`` and ``b (out,)``, and the
torch.nn.Linear default init U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with the
last layer's bias zero.  The other shading modes (SH, RGB, MLP_PE, MLP)
are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.encoding import positional_encoding
from ..ops.freq_mask import FreeMasks
from .config import ModelConfig


class Linear(nn.Module):
    """x @ w + b with w (fan_in, fan_out), the JAX parameter layout."""

    def __init__(self, fan_in: int, fan_out: int, generator: torch.Generator,
                 zero_bias: bool = False):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)

        def uniform(*shape):
            return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

        self.w = nn.Parameter(uniform(fan_in, fan_out))
        self.b = nn.Parameter(
            torch.zeros(fan_out) if zero_bias else uniform(fan_out)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def _require_mlp_fea(cfg: ModelConfig) -> None:
    if cfg.shading_mode != "MLP_Fea":
        raise NotImplementedError(
            f"shading mode {cfg.shading_mode!r} is not ported yet (MLP_Fea only)"
        )
    if cfg.dtype != "float32":
        raise NotImplementedError("the shading MLP runs in float32 only")


def mlp_in_dim(cfg: ModelConfig) -> int:
    """Input width of the MLP_Fea shading MLP."""
    _require_mlp_fea(cfg)
    return 2 * cfg.view_pe * 3 + 2 * cfg.fea_pe * cfg.app_dim + 3 + cfg.app_dim


class MLPFea(nn.Module):
    """Three-layer MLP over [features, viewdirs, PE(features), PE(viewdirs)]."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d_in, c = mlp_in_dim(cfg), cfg.feature_c
        self.l1 = Linear(d_in, c, generator)
        self.l2 = Linear(c, c, generator)
        self.l3 = Linear(c, 3, generator, zero_bias=True)


def init_shading(cfg: ModelConfig, generator: torch.Generator) -> MLPFea:
    return MLPFea(cfg, generator)


def _masked_pe(x: torch.Tensor, freqs: int, mask: Optional[torch.Tensor]):
    enc = positional_encoding(x, freqs)
    return enc if mask is None else enc * mask


def apply_shading(
    cfg: ModelConfig,
    mlp: MLPFea,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    features: torch.Tensor,
    masks: FreeMasks,
) -> torch.Tensor:
    """points/viewdirs/features (M, ·) -> rgb (M, 3) in [0, 1].

    The input concatenation order is the reference's MLP_Fea order.
    ``pts`` is unused by MLP_Fea; it stays for the JAX signature.
    """
    _require_mlp_fea(cfg)
    indata = [features, viewdirs]
    if cfg.fea_pe > 0:
        indata.append(_masked_pe(features, cfg.fea_pe, masks.fea))
    if cfg.view_pe > 0:
        indata.append(_masked_pe(viewdirs, cfg.view_pe, masks.view))
    x = torch.cat(indata, dim=-1)
    x = torch.relu(mlp.l1(x))
    x = torch.relu(mlp.l2(x))
    return torch.sigmoid(mlp.l3(x))
