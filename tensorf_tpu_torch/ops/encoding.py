"""Sinusoidal positional encoding (counterpart of tensorf_tpu/ops/encoding.py).

Frequencies 2^k, k=0..F-1, dim-major layout ``[x*f0, x*f1, ..., y*f0, ...]``
then ``cat(sin, cos)``; FreeNeRF frequency masks index this layout.
"""

from __future__ import annotations

import torch


def positional_encoding(positions: torch.Tensor, freqs: int) -> torch.Tensor:
    """positions (..., D) -> (..., 2*D*freqs)."""
    freq_bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype, device=positions.device)
    pts = positions[..., None] * freq_bands
    pts = pts.reshape(*positions.shape[:-1], positions.shape[-1] * freqs)
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)
