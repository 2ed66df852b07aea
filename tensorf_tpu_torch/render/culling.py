"""Dense-alpha extraction, alpha-mask updates and ray-set filtering
(counterpart of tensorf_tpu/render/culling.py without the stratification
counts, which serve the sample budgets and are not ported yet).

The dense sweeps run slice by slice on the field's device under no_grad;
the shape-changing decisions (the new aabb, which rays stay) are made at
the schedule events, as in the reference (models/tensorBase.py:214-288).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.alpha_mask import AlphaGridMask, max_pool_3d_same, sample_alpha_gate, with_dilation
from ..ops.rays import aabb_entry_exit, sample_along_rays
from .volume import feature2density, normalize_coord


def _bbox_hit(rays: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    t_min, t_max = aabb_entry_exit(rays[:, :3], rays[:, 3:6], aabb)
    return t_max > t_min


def _chunked_mask(fn, rays: torch.Tensor, chunk: int) -> torch.Tensor:
    return torch.cat([fn(rays[s : s + chunk]) for s in range(0, rays.shape[0], chunk)])


def filter_rays_bbox(
    all_rays, all_rgbs, aabb, device, chunk: int = 51200
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep rays whose line intersects the scene bbox (reference
    filtering_rays bbox_only=True).  Returns the kept rays and colors as
    tensors on ``device`` — the device-resident ray store."""
    rays = torch.as_tensor(np.asarray(all_rays, np.float32), device=device)
    rgbs = torch.as_tensor(np.asarray(all_rgbs, np.float32), device=device)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=device)
    mask = _chunked_mask(lambda r: _bbox_hit(r, aabb_t), rays, chunk)
    kept = int(mask.sum())
    print(
        f"========> bbox ray filtering: kept {kept}/{mask.numel()} "
        f"({kept / max(mask.numel(), 1):.3f})"
    )
    return rays[mask], rgbs[mask]


def _linspace01(n: int, device) -> torch.Tensor:
    """n points from 0 to 1 as jnp.linspace computes them in float32
    (iota times the reciprocal of n - 1, the last point exactly 1)."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) * float(
        np.float32(1) / np.float32(n - 1)
    )
    return torch.cat([step, torch.ones(1, device=device)])


def _alpha_at(field, alpha_mask, xyz, aabb, den_mask, length: float) -> torch.Tensor:
    """alpha = 1 - exp(-sigma * length) at world points (M, 3), with the
    alpha-mask gate (reference compute_alpha, tensorBase.py:298-318)."""
    xyz_n = normalize_coord(xyz, aabb)
    sigma = feature2density(field.cfg, field.density_feature(xyz_n, den_mask))
    if alpha_mask is not None:
        gate = sample_alpha_gate(alpha_mask, xyz) > 0
        sigma = torch.where(gate, sigma, torch.zeros((), device=xyz.device))
    return 1.0 - torch.exp(-sigma * length)


@torch.no_grad()
def compute_alpha_grid(
    field,
    alpha_mask: Optional[AlphaGridMask],
    aabb,
    grid_size: Tuple[int, int, int],
    step_size: float,
    den_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (gx, gy, gz) alpha grid and its (gx, gy, gz, 3) world-space
    lattice, on the field's device (reference getDenseAlpha,
    tensorBase.py:214-230): a 0..1 lattice lerped into the aabb, evaluated
    one x-slice at a time."""
    dev = field.basis.device
    gx, gy, gz = (int(g) for g in grid_size)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=dev)
    samples = torch.stack(
        torch.meshgrid(_linspace01(gx, dev), _linspace01(gy, dev), _linspace01(gz, dev),
                       indexing="ij"),
        dim=-1,
    )
    dense_xyz = aabb_t[0] * (1 - samples) + aabb_t[1] * samples
    alpha = torch.empty((gx, gy, gz), device=dev)
    for i in range(gx):
        alpha[i] = _alpha_at(
            field, alpha_mask, dense_xyz[i].reshape(-1, 3), aabb_t, den_mask, float(step_size)
        ).reshape(gy, gz)
    return alpha, dense_xyz


@torch.no_grad()
def update_alpha_mask(
    field,
    alpha_mask: Optional[AlphaGridMask],
    aabb,
    grid_size: Tuple[int, int, int],
    step_size: float,
    den_mask=None,
) -> Tuple[AlphaGridMask, np.ndarray, float]:
    """Rebuild the occupancy mask and find the tight new aabb (reference
    updateAlphaMask, tensorBase.py:232-256): clamp, transpose to (z, y, x),
    3x3x3 max-pool, threshold at the model's ``alpha_mask_thres``.  The mask
    keeps ``aabb``; the new aabb spans its occupied lattice points.
    Returns (mask, new_aabb (2, 3) float32, occupancy ratio)."""
    alpha, dense_xyz = compute_alpha_grid(field, alpha_mask, aabb, grid_size, step_size, den_mask)
    vol = torch.clamp(alpha, 0, 1).permute(2, 1, 0).contiguous()  # (z, y, x)
    vol = max_pool_3d_same(vol, ks=3)
    vol = (vol >= field.cfg.alpha_mask_thres).to(torch.float32)
    del alpha

    occupied = vol > 0.5
    count = int(occupied.sum())
    if count == 0:
        new_aabb = np.asarray(aabb, np.float32).reshape(2, 3)
    else:
        xyz_zyx = dense_xyz.permute(2, 1, 0, 3)
        inf = torch.tensor(float("inf"), device=vol.device)
        lo = torch.where(occupied[..., None], xyz_zyx, inf).reshape(-1, 3).amin(dim=0)
        hi = torch.where(occupied[..., None], xyz_zyx, -inf).reshape(-1, 3).amax(dim=0)
        new_aabb = torch.stack([lo, hi]).cpu().numpy()
    ratio = float(np.float32(count) / vol.numel())
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=vol.device)
    return with_dilation(AlphaGridMask(aabb=aabb_t, volume=vol)), new_aabb, ratio


@torch.no_grad()
def _alpha_hit(rays, alpha_mask, aabb, *, n_samples, step_size, near, far) -> torch.Tensor:
    xyz, _, valid = sample_along_rays(
        rays[:, :3], rays[:, 3:6], aabb, near, far, step_size, n_samples, None
    )
    alive = valid & (sample_alpha_gate(alpha_mask, xyz) > 0)
    return torch.any(alive, dim=-1)


@torch.no_grad()
def filter_rays_alpha(
    rays: torch.Tensor,
    rgbs: torch.Tensor,
    alpha_mask: AlphaGridMask,
    aabb,
    step_size: float,
    near_far=(2.0, 6.0),
    n_samples: int = 256,
    chunk: int = 51200,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the rays of the store with any alive sample under the alpha
    mask (reference filtering_rays bbox_only=False, tensorBase.py:279-281).
    ``n_samples`` is 256 as in the reference call, not the step's lattice.
    An empty result keeps the store unfiltered, with a notice."""
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3), device=rays.device)
    mask = _chunked_mask(
        lambda r: _alpha_hit(
            r, alpha_mask, aabb_t, n_samples=n_samples, step_size=float(step_size),
            near=float(near_far[0]), far=float(near_far[1]),
        ),
        rays,
        chunk,
    )
    kept = int(mask.sum())
    print(
        f"========> alpha ray filtering: kept {kept}/{mask.numel()} "
        f"({kept / max(mask.numel(), 1):.3f})"
    )
    if kept == 0:
        print("========> alpha ray filtering kept nothing; skipping filter")
        return rays, rgbs
    return rays[mask], rgbs[mask]
