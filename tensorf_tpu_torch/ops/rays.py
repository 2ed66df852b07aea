"""Ray generation, AABB tests and ray sampling (counterpart of
tensorf_tpu/ops/rays.py).

Pixel-grid directions and world rays stay host-side numpy, computed once
per dataset.  The samplers are torch.  Where the JAX version takes a PRNG
key, these take the jitter itself — ``u`` (B, 1), one uniform per ray, or
None for the deterministic eval lattice — so tests can inject JAX's draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _pixel_grid(H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-center grid (i over width, j over height), +0.5 centering."""
    j, i = np.meshgrid(
        np.arange(H, dtype=np.float32) + 0.5,
        np.arange(W, dtype=np.float32) + 0.5,
        indexing="ij",
    )
    return i, j


def get_ray_directions(H, W, focal, center=None) -> np.ndarray:
    """OpenCV-convention camera-space directions (H, W, 3): +z forward."""
    i, j = _pixel_grid(H, W)
    cent = center if center is not None else [W / 2, H / 2]
    return np.stack(
        [(i - cent[0]) / focal[0], (j - cent[1]) / focal[1], np.ones_like(i)],
        axis=-1,
    )


def get_ray_directions_blender(H, W, focal, center=None) -> np.ndarray:
    """Blender/OpenGL convention (H, W, 3): y up, -z forward."""
    i, j = _pixel_grid(H, W)
    cent = center if center is not None else [W / 2, H / 2]
    return np.stack(
        [(i - cent[0]) / focal[0], -(j - cent[1]) / focal[1], -np.ones_like(i)],
        axis=-1,
    )


def get_rays(directions, c2w) -> Tuple[np.ndarray, np.ndarray]:
    """Camera-space dirs (H, W, 3) + pose (3/4, 4) -> world rays (H*W, 3) x2.

    Directions are intentionally not normalized (the reference keeps the
    un-normalized rotation product).
    """
    directions = np.asarray(directions)
    c2w = np.asarray(c2w)
    rays_d = directions @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).copy(), rays_d.reshape(-1, 3)


def aabb_entry_exit(
    rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab-method entry/exit distances (t_min, t_max), each (B,).

    Zero direction components are replaced by 1e-6, as the reference's
    bbox ray filter does.
    """
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (aabb[1] - rays_o) / vec
    rate_b = (aabb[0] - rays_o) / vec
    t_min = torch.amax(torch.minimum(rate_a, rate_b), dim=-1)
    t_max = torch.amin(torch.maximum(rate_a, rate_b), dim=-1)
    return t_min, t_max


def sample_lattice(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    near: float,
    far: float,
) -> torch.Tensor:
    """Per-ray lattice start t_min (B,): the bbox entry clamped to [near, far].

    The non-NDC lattice is affine in the sample index — z(i) = t_min +
    (i + u) * step — so any subset of it can be re-materialized from
    indices alone (see lattice_z).
    """
    t_min, _ = aabb_entry_exit(rays_o, rays_d, aabb)
    return torch.clamp(t_min, near, far)


def lattice_z(
    t_min: torch.Tensor,
    u: Optional[torch.Tensor],
    idx: torch.Tensor,
    step_size: float,
) -> torch.Tensor:
    """Sample depths at (float) lattice indices idx (B|1, K) -> z (B, K)."""
    rng = idx if u is None else idx + u
    return t_min[:, None] + rng * step_size


def sample_along_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    near: float,
    far: float,
    step_size: float,
    n_samples: int,
    u: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-count stratified samples from the bbox entry point.

    t_min from the slab test clamped to [near, far]; depths t_min +
    step*(arange + u) with one uniform ``u`` (B, 1) per ray at train time
    (None at eval); per-sample validity = point inside the aabb.

    Returns (xyz (B, N, 3), z_vals (B, N), ray_valid (B, N) bool).
    """
    B = rays_o.shape[0]
    t_min = sample_lattice(rays_o, rays_d, aabb, near, far)
    idx = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)[None, :]
    z_vals = lattice_z(t_min, u, idx, step_size)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    outside = torch.any((xyz < aabb[0]) | (xyz > aabb[1]), dim=-1)
    return xyz, z_vals.expand(B, n_samples), ~outside
