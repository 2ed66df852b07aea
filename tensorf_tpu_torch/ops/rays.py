"""Ray generation, NDC projection, AABB tests and ray sampling
(counterpart of tensorf_tpu/ops/rays.py).

Pixel-grid directions and world rays stay host-side numpy, computed once
per dataset; the NDC projections take numpy arrays or tensors.  The
samplers are torch.  Where the JAX version takes a PRNG key, these take
the jitter itself — ``u`` (B, 1), one uniform per ray, or for NDC rays
``jitter`` (B, N), one per sample; None for the deterministic eval
lattice — so tests can inject JAX's draw.
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


def _stack(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts, -1)
    return np.stack(parts, -1)


def ndc_rays_blender(H, W, focal, near, rays_o, rays_d):
    """Blender-convention NDC projection of (..., 3) rays (numpy or torch):
    the origins moved onto the near plane z = -near, then projected."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]
    return _stack([o0, o1, o2]), _stack([d0, d1, d2])


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    """OpenCV-convention NDC projection of (..., 3) rays (numpy or torch)."""
    t = (near - rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = 1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = 1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 - 2.0 * near / rays_o[..., 2]

    d0 = 1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = 1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = 2.0 * near / rays_o[..., 2]
    return _stack([o0, o1, o2]), _stack([d0, d1, d2])


def ndc_bbox(all_rays) -> np.ndarray:
    """Tight (2, 3) bbox over the NDC rays' extents: each ray from its
    origin to origin + direction."""
    rays = np.asarray(all_rays).reshape(-1, all_rays.shape[-1])
    near = rays[:, :3]
    far = rays[:, :3] + rays[:, 3:6]
    lo = np.minimum(near.min(0), far.min(0))
    hi = np.maximum(near.max(0), far.max(0))
    print(f"===> ndc bbox near/far extents: {lo} {hi}")
    return np.stack([lo, hi])


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


def aabb_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """(B,) bool: whether each ray's infinite line meets the box."""
    t_min, t_max = aabb_entry_exit(rays_o, rays_d, aabb)
    return t_max > t_min


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


def inbbox_chord(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    near: float,
    far: float,
    step_size: float,
    n_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form in-bbox sample run of each ray: (t0 (B,), hit (B,) bool,
    chord (B,) int32).  Samples march from the clamped bbox entry t0
    through a convex box, so the valid lattice indices are [0, chord).
    The chord carries +1 sample of float32 slack over the per-sample
    inside-aabb test; a miss (including one with t_min past ``far``) gets 0.
    """
    t_min, t_max = aabb_entry_exit(rays_o, rays_d, aabb)
    t0 = torch.clamp(t_min, near, far)
    hit = (t_max >= t_min) & (t_max >= t0)
    n_in = torch.floor((t_max - t0) / step_size) + 2.0
    chord = torch.clamp(torch.where(hit, n_in, torch.zeros_like(n_in)), 0, n_samples)
    return t0, hit, chord.to(torch.int32)


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


def linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """n float32 points from start to stop as jnp.linspace computes them:
    start (1 - s) + stop s, s = iota times the float32 reciprocal of
    n - 1, the last point exactly stop."""
    if n == 1:
        return torch.full((1,), float(start), device=device)
    s = torch.arange(n - 1, dtype=torch.float32, device=device) * float(
        np.float32(1) / np.float32(n - 1)
    )
    out = float(np.float32(start)) * (1 - s) + float(np.float32(stop)) * s
    return torch.cat([out, torch.full((1,), float(np.float32(stop)), device=device)])


def sample_along_rays_ndc(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    jitter: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """linspace(near, far, n_samples) depths, each moved at train time by
    its own uniform ``jitter`` (B, N) times (far - near) / n_samples (None
    at eval); per-sample validity = point inside the aabb.

    Returns (xyz (B, N, 3), z_vals (B, N), ray_valid (B, N) bool).
    """
    B = rays_o.shape[0]
    interpx = linspace(near, far, n_samples, rays_o.device)[None, :]
    if jitter is not None:
        interpx = interpx + jitter * ((far - near) / n_samples)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
    outside = torch.any((xyz < aabb[0]) | (xyz > aabb[1]), dim=-1)
    return xyz, interpx.expand(B, n_samples), ~outside


# ---------------------------------------------------------------------------
# Generic sampling helpers of the reference's ray utilities
# (dataLoader/ray_utils.py: depth2dist :9, ndc2dist :18, sample_pdf :129,
# dda :174, ray_marcher :184), which the trainer does not call but users
# of the package may.  Where the JAX versions take a PRNG key, these take
# the uniforms ``u`` themselves or a ``torch.Generator`` to draw them.
# ---------------------------------------------------------------------------


def depth2dist(z_vals: torch.Tensor, cos_angle: torch.Tensor) -> torch.Tensor:
    """Per-sample distances from depths (the last one 1e10), scaled by the
    ray angle's cosine."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    return dists * cos_angle[..., None]


def ndc2dist(ndc_pts: torch.Tensor, cos_angle: torch.Tensor) -> torch.Tensor:
    """Distances between consecutive NDC points (B, N, 3), the last one
    1e10 times the cosine."""
    dists = torch.linalg.norm(ndc_pts[:, 1:] - ndc_pts[:, :-1], dim=-1)
    return torch.cat([dists, 1e10 * cos_angle[..., None]], dim=-1)


def _uniforms(shape, device, u, generator):
    """The injected ``u``, else uniforms from ``generator``, else None."""
    if u is not None:
        return torch.as_tensor(u, dtype=torch.float32, device=device).expand(shape)
    if generator is not None:
        return torch.rand(shape, generator=generator, device=generator.device).to(device)
    return None


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int, det: bool = False,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF hierarchical sampling (reference ray_utils.py:129-171).

    bins (..., N + 1) edges, weights (..., N) -> (..., n_samples) depths.
    The quantiles are linspace(0, 1) when ``det`` is set or nothing random
    is given, else ``u`` (..., n_samples) or uniforms from ``generator``.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = (*cdf.shape[:-1], n_samples)
    q = None if det else _uniforms(shape, cdf.device, u, generator)
    if q is None:
        q = linspace(0.0, 1.0, n_samples, cdf.device).expand(shape)
    q = q.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), q, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_b = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_a = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (q - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def dda(rays_o: torch.Tensor, rays_d: torch.Tensor,
        bbox_3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab entry and exit (B, 1) with the reference's epsilon
    (ray_utils.py:174-181)."""
    inv = 1.0 / (rays_d + 1e-6)
    t0 = (bbox_3d[:1] - rays_o) * inv
    t1 = (bbox_3d[1:] - rays_o) * inv
    t_min = torch.amax(torch.minimum(t0, t1), dim=-1, keepdim=True)
    t_max = torch.amin(torch.maximum(t0, t1), dim=-1, keepdim=True)
    return t_min, t_max


def ray_marcher(rays: torch.Tensor, n_samples: int = 64, lindisp: bool = False,
                perturb: float = 0.0, bbox_3d: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
    """Stratified samples over (o, d, near, far) ray packets (B, 8)
    (reference ray_utils.py:184-228).  With ``perturb`` > 0 each depth moves
    within its stratum by ``perturb`` times ``u`` (B, n_samples) or
    uniforms from ``generator``.  Returns (xyz, rays_o, rays_d, z_vals)."""
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    if bbox_3d is not None:
        near, far = dda(rays_o, rays_d, bbox_3d)
    z_steps = linspace(0.0, 1.0, n_samples, rays.device)
    if not lindisp:
        z_vals = near * (1 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1 - z_steps) + 1.0 / far * z_steps)
    z_vals = z_vals.expand(rays.shape[0], n_samples)
    jitter = _uniforms(z_vals.shape, rays.device, u, generator) if perturb > 0 else None
    if jitter is not None:
        mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * (perturb * jitter)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return xyz, rays_o, rays_d, z_vals
