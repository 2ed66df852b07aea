"""Shading heads (counterpart of tensorf_tpu/models/shading.py): the MLP
variants MLP_Fea, MLP_PE and MLP with their FreeNeRF PE masks, SH, and
plain RGB.

MLP weights keep the JAX layout, ``w (in, out)`` and ``b (out,)``, and the
torch.nn.Linear default init U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with the
last layer's bias zero.  SH and RGB have no parameters.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.encoding import positional_encoding
from ..ops.freq_mask import FreeMasks
from ..ops.sh import eval_sh_bases
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
        """In x's dtype: the float32 weights are cast to it per call."""
        return x @ self.w.to(x.dtype) + self.b.to(x.dtype)


MODES = ("MLP_Fea", "MLP_PE", "MLP", "SH", "RGB")


# the dtypes a model config's ``dtype`` (the MLP's), ``grid_dtype`` and
# ``line_dtype`` name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config's dtype option names."""
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}: the port runs {sorted(DTYPES)}")
    return DTYPES[name]


def _check(cfg: ModelConfig) -> torch.dtype:
    """Refuses an unknown mode or dtype; returns the MLP's compute dtype."""
    if cfg.shading_mode not in MODES:
        raise ValueError(f"unrecognized shading mode {cfg.shading_mode}")
    return torch_dtype(cfg.dtype)


def mlp_in_dim(cfg: ModelConfig) -> int:
    """Input width of the shading MLP (reference models/mlp.py:31/75/113)."""
    mode = cfg.shading_mode
    if mode == "MLP_Fea":
        return 2 * cfg.view_pe * 3 + 2 * cfg.fea_pe * cfg.app_dim + 3 + cfg.app_dim
    if mode == "MLP_PE":
        return (3 + 2 * cfg.view_pe * 3) + (2 * cfg.pos_pe * 3) + cfg.app_dim
    if mode == "MLP":
        return (2 * cfg.pos_pe * 3 + 2 * cfg.view_pe * 3 + 2 * cfg.fea_pe * cfg.app_dim
                + cfg.app_dim + 3)
    raise ValueError(f"no MLP input dim for shading mode {mode}")


class ShadingMLP(nn.Module):
    """Three layers over the mode's input concatenation."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d_in, c = mlp_in_dim(cfg), cfg.feature_c
        self.l1 = Linear(d_in, c, generator)
        self.l2 = Linear(c, c, generator)
        self.l3 = Linear(c, 3, generator, zero_bias=True)


def init_shading(cfg: ModelConfig, generator: torch.Generator) -> nn.Module:
    """The shading parameters: an MLP, or a module with none for the
    parameter-free SH and RGB (the JAX package's ``{}``), so a field's
    state dict and optimizer carry no ``render`` entries for them."""
    _check(cfg)
    if cfg.shading_mode in ("SH", "RGB"):
        return nn.Module()
    return ShadingMLP(cfg, generator)


def _masked_pe(x: torch.Tensor, freqs: int, mask: Optional[torch.Tensor]):
    enc = positional_encoding(x, freqs)
    return enc if mask is None else enc * mask


def apply_shading(
    cfg: ModelConfig,
    mlp: nn.Module,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    features: torch.Tensor,
    masks: FreeMasks,
) -> torch.Tensor:
    """points/viewdirs/features (M, ·) -> rgb (M, 3) in [0, 1].

    ``pts`` are the normalized sample positions.  The input concatenation
    order is each reference variant's (models/mlp.py:41-66, 85-107,
    125-154).
    """
    compute_dtype = _check(cfg)
    mode = cfg.shading_mode
    if mode == "SH":
        sh_mult = eval_sh_bases(2, viewdirs)[:, None, :]  # (M, 1, 9)
        rgb_sh = features.reshape(-1, 3, sh_mult.shape[-1])
        return torch.relu(torch.sum(sh_mult * rgb_sh, dim=-1) + 0.5)
    if mode == "RGB":
        return features

    indata = [features, viewdirs]
    if mode in ("MLP_PE", "MLP") and cfg.pos_pe > 0:
        indata.append(_masked_pe(pts, cfg.pos_pe, masks.pos))
    if mode == "MLP_Fea" and cfg.fea_pe > 0:
        indata.append(_masked_pe(features, cfg.fea_pe, masks.fea))
    if cfg.view_pe > 0:
        indata.append(_masked_pe(viewdirs, cfg.view_pe, masks.view))
    if mode == "MLP" and cfg.fea_pe > 0:
        indata.append(_masked_pe(features, cfg.fea_pe, masks.fea))
    # the MLP in the compute dtype, the sigmoid in float32 (JAX
    # shading.py:115-120)
    x = torch.cat(indata, dim=-1).to(compute_dtype)
    x = torch.relu(mlp.l1(x))
    x = torch.relu(mlp.l2(x))
    return torch.sigmoid(mlp.l3(x).float())
