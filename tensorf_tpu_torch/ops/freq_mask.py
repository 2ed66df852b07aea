"""FreeNeRF frequency-regularization masks (counterpart of
tensorf_tpu/ops/freq_mask.py).

Per-frequency vector masks over the positional-encoding channels and
per-rank masks over the decomposition components, each a closed-form
function of the step.  The step is a host integer here (PyTorch runs
eagerly), and the arithmetic is float32 as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def freq_reg_mask(
    length: int,
    step: int,
    total_reg_steps: int,
    ratio: float = 1.0,
    max_visible: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    """Linear frequency curriculum mask of shape (length,), float32.

    The visible prefix grows linearly with step/total in groups of dv=4
    channels, with a fractional band for the partially visible group;
    values are clamped to [1e-8, 1-1e-8] while the curriculum is active and
    are exactly 1 once step >= total_reg_steps.
    """
    f32 = torch.float32
    if max_visible is not None:
        idx = torch.arange(length, device=device)
        return (idx < int(length * max_visible)).to(f32)

    dv = 4
    step_t = torch.tensor(float(step), dtype=f32, device=device)
    eff_len = length * float(ratio)
    ptr = torch.minimum(
        eff_len / dv * step_t / total_reg_steps + 1.0,
        torch.tensor(eff_len / dv, dtype=f32, device=device),
    )
    int_ptr = torch.floor(ptr)
    frac = ptr - int_ptr
    idx = torch.arange(length, dtype=f32, device=device)
    one = torch.ones((), dtype=f32, device=device)
    mask = torch.where(
        idx < int_ptr * dv,
        one,
        torch.where(idx < int_ptr * dv + dv, frac, torch.zeros_like(one)),
    )
    mask = torch.clamp(mask, 1e-8, 1.0 - 1e-8)
    if step < total_reg_steps:
        return mask
    return torch.ones(length, dtype=f32, device=device)


class FreeMasks(NamedTuple):
    """Per-step FreeNeRF masks threaded through shading + feature gathers.

    ``pos/view/fea`` multiply the corresponding PE channels; ``den/app`` are
    per-axis tuples of per-rank masks.  Any entry may be None (mask off).
    """

    pos: Optional[torch.Tensor] = None
    view: Optional[torch.Tensor] = None
    fea: Optional[torch.Tensor] = None
    den: Optional[Tuple[torch.Tensor, ...]] = None
    app: Optional[Tuple[torch.Tensor, ...]] = None


def free_masks(
    pos_len: int,
    view_len: int,
    fea_len: int,
    den_ranks: Tuple[int, ...],
    app_ranks: Tuple[int, ...],
    step: int,
    total_steps: int,
    ratio: float = 1.0,
    use_decomp_mask: bool = True,
    max_visible: Optional[float] = None,
    device=None,
) -> FreeMasks:
    """Build the full mask bundle."""

    def mask(length):
        return freq_reg_mask(length, step, total_steps, ratio, max_visible, device)

    def enc(length):
        return mask(length) if length > 0 else None

    den = app = None
    if use_decomp_mask:
        if len(den_ranks) > 0:
            den = tuple(mask(r) for r in den_ranks)
        if len(app_ranks) > 0:
            app = tuple(mask(r) for r in app_ranks)
    return FreeMasks(
        pos=enc(pos_len), view=enc(view_len), fea=enc(fea_len), den=den, app=app
    )
