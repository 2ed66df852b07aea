"""The train step: render + losses + backward + Adam (counterpart of the
non-stratified branch of tensorf_tpu/train/step.py).

PyTorch runs it eagerly; there is no jit counterpart.  Where the JAX step
splits a key, this step draws the same two pieces of noise from a
torch.Generator on the device: the per-ray lattice jitter ``u`` (B, 1) and
the background flip.  ``loss_fn`` takes them explicitly so tests can feed
JAX's own draw.  The stratified sub-batches and sample budgets are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..ops.freq_mask import FreeMasks, free_masks
from ..render.volume import render_rays
from .losses import LossWeights, mse_loss, occlusion_loss


class TrainStatics(NamedTuple):
    """Per-segment static configuration for the train step."""

    n_samples: int
    step_size: float
    white_bg: bool
    ndc_ray: bool
    total_steps: int
    lr_factor: float
    weights: LossWeights = LossWeights()
    free_reg: bool = False
    free_decomp: bool = False
    freq_reg_ratio: float = 1.0
    max_visible: Optional[float] = None
    shade_top_k: Optional[int] = None
    fused: bool = True


def _build_masks(cfg: ModelConfig, statics: TrainStatics, step: int, device) -> FreeMasks:
    if not statics.free_reg:
        return FreeMasks()
    return free_masks(
        pos_len=cfg.pos_bit_length,
        view_len=cfg.view_bit_length,
        fea_len=cfg.fea_bit_length,
        den_ranks=cfg.density_n_comp,
        app_ranks=cfg.app_n_comp,
        step=step,
        total_steps=statics.total_steps,
        ratio=statics.freq_reg_ratio,
        use_decomp_mask=statics.free_decomp,
        max_visible=statics.max_visible,
        device=device,
    )


def loss_fn(
    field,
    statics: TrainStatics,
    aabb: torch.Tensor,
    rays: torch.Tensor,
    rgbs: torch.Tensor,
    step: int,
    u: Optional[torch.Tensor],
    flip: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its parts for one batch at iteration ``step``."""
    cfg = field.cfg
    lw = statics.weights
    masks = _build_masks(cfg, statics, step, rays.device)
    out = render_rays(
        field, rays, masks,
        aabb=aabb,
        step_size=statics.step_size,
        n_samples=statics.n_samples,
        is_train=True,
        white_bg=statics.white_bg,
        ndc_ray=statics.ndc_ray,
        shade_top_k=statics.shade_top_k,
        fused=statics.fused,
        u=u,
        flip=flip,
    )
    mse = mse_loss(out.rgb, rgbs)
    total = mse
    metrics = {
        "mse": mse,
        "num_valid_samples": out.num_valid_samples,
        "mean_alive_samples": out.mean_alive_samples,
    }
    if lw.occ > 0 and lw.occ_range > 0:
        reg = occlusion_loss(out.sigma, rgbs, lw.occ_range, lw.occ_wb_range, lw.occ_wb_prior)
        total = total + lw.occ * reg
        metrics["reg_occ"] = reg

    # TV weights decay by lr_factor each step; step t uses w0 * factor^(t+1).
    tv_decay = float(torch.pow(torch.tensor(statics.lr_factor, dtype=torch.float32),
                               torch.tensor(step + 1.0, dtype=torch.float32)))
    if lw.ortho > 0 and getattr(field, "has_ortho", False):
        reg = field.ortho_reg()
        total = total + lw.ortho * reg
        metrics["reg_ortho"] = reg
    if lw.l1 > 0:
        reg = field.density_l1()
        total = total + lw.l1 * reg
        metrics["reg_l1"] = reg
    if lw.tv_density > 0:
        reg = field.tv_density() * lw.tv_density * tv_decay
        total = total + reg
        metrics["reg_tv_density"] = reg
    if lw.tv_app > 0:
        reg = field.tv_app() * lw.tv_app * tv_decay
        total = total + reg
        metrics["reg_tv_app"] = reg
    return total, metrics


def draw_noise(
    generator: torch.Generator, batch: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u (B, 1) lattice jitter, flip scalar 0/1) for one train step."""
    u = torch.rand((batch, 1), generator=generator, device=device)
    flip = (torch.rand((), generator=generator, device=device) < 0.5).to(torch.float32)
    return u, flip


def make_train_step(field, statics: TrainStatics, optimizer):
    """Returns ``step_fn(aabb, rays, rgbs, step, generator) -> metrics``,
    which updates ``field`` in place through ``optimizer``."""

    def step_fn(aabb, rays, rgbs, step: int, generator: torch.Generator):
        u, flip = draw_noise(generator, rays.shape[0], rays.device)
        optimizer.zero_grad()
        total, metrics = loss_fn(field, statics, aabb, rays, rgbs, step, u, flip)
        total.backward()
        optimizer.step()
        metrics["total_loss"] = total.detach()
        metrics["psnr"] = -10.0 * torch.log10(metrics["mse"].detach())
        return metrics

    return step_fn
