"""Fixed-shape masked volume renderer (counterpart of
tensorf_tpu/render/volume.py), for the unbudgeted non-NDC path.

Dead samples contribute exactly zero density / radiance through ``where``
gates over the full (B, n_samples) lattice.  Shading runs where the weight
passes ``ray_march_weight_thres`` — over every sample, or (``shade_top_k``)
over the top-K weights per ray only.  With an alpha mask, a sample lives
only where the mask's nearest-neighbour gate is set.  Sample budgets, NDC
rays and serving window bits are not ported yet and raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.alpha_mask import AlphaGridMask, sample_alpha_gate
from ..models.config import ModelConfig
from ..models.shading import apply_shading
from ..ops.freq_mask import FreeMasks
from ..ops.rays import sample_along_rays
from ..ops.render_math import raw2alpha


def normalize_coord(xyz: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """World -> [-1, 1] grid coords."""
    inv = 2.0 / (aabb[1] - aabb[0])
    return (xyz - aabb[0]) * inv - 1.0


def feature2density(cfg: ModelConfig, feat: torch.Tensor) -> torch.Tensor:
    """softplus(x + density_shift) or relu."""
    if cfg.fea2dense_act == "softplus":
        return torch.nn.functional.softplus(feat + cfg.density_shift)
    if cfg.fea2dense_act == "relu":
        return torch.relu(feat)
    raise ValueError(f"unknown fea2dense_act {cfg.fea2dense_act}")


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # (B, 3)
    depth: torch.Tensor  # (B,)
    acc: torch.Tensor  # (B,)
    weights: torch.Tensor  # (B, N)
    sigma: torch.Tensor  # (B, N)
    z_vals: torch.Tensor  # (B, N)
    num_valid_samples: torch.Tensor  # scalar
    mean_alive_samples: torch.Tensor  # scalar: mean in-bbox samples per ray


def render_rays(
    field,
    rays: torch.Tensor,
    masks: FreeMasks,
    *,
    aabb: torch.Tensor,
    step_size: float,
    n_samples: int,
    is_train: bool,
    white_bg: bool,
    ndc_ray: bool = False,
    shade_top_k: Optional[int] = None,
    fused: bool = True,
    sample_budget: Optional[int] = None,
    alpha_mask: Optional[AlphaGridMask] = None,
    cand_window_bits=None,
    u: Optional[torch.Tensor] = None,
    flip: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Volume-render a batch of rays (B, 6) -> RenderOutput.

    ``field`` is a TensorVMSplit; ``masks`` the per-step FreeNeRF bundle;
    ``alpha_mask`` (or None) gates samples by occupancy.
    Where the JAX version takes a key, this takes the noise itself: ``u``
    (B, 1) is the per-ray lattice jitter and ``flip`` (scalar 0/1) the
    train-time random white-background flip for datasets whose background
    is not white.  Both None give the deterministic eval render.
    """
    if sample_budget is not None and sample_budget < n_samples:
        raise NotImplementedError("sample budgets are not ported yet")
    if ndc_ray:
        raise NotImplementedError("NDC rays are not ported yet")
    if cand_window_bits is not None:
        raise NotImplementedError("serving window bits are not ported yet")

    cfg = field.cfg
    B = rays.shape[0]
    rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
    near, far = cfg.near_far

    xyz, z_vals, ray_valid = sample_along_rays(
        rays_o, viewdirs, aabb, near, far, step_size, n_samples, u
    )
    dists = torch.cat(
        [z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], dim=-1
    )
    if alpha_mask is not None:
        # occupancy gate (reference tensorBase.py:349-354)
        ray_valid = ray_valid & (sample_alpha_gate(alpha_mask, xyz) > 0)
    mean_alive = torch.mean(torch.sum(ray_valid.to(torch.float32), dim=-1))
    xyz_n = normalize_coord(xyz, aabb)  # (B, N, 3)
    N = n_samples

    def sigma_of(den_feat):
        return torch.where(
            ray_valid, feature2density(cfg, den_feat.reshape(B, N)), torch.zeros((), device=rays.device)
        )

    def shade(pts, app_feat, K):
        view = viewdirs[:, None, :].expand(B, K, 3).reshape(-1, 3)
        return apply_shading(cfg, field.render, pts, view, app_feat, masks).reshape(B, K, 3)

    top_k = shade_top_k is not None and shade_top_k < N
    if fused and not top_k:
        # One packed gather pass for density + appearance.
        den_feat, app_feat = field.fused_features(xyz_n.reshape(-1, 3), masks.den, masks.app)
    elif fused:
        den_feat = field.density_feature_fused(xyz_n.reshape(-1, 3), masks.den)
    else:
        den_feat = field.density_feature(xyz_n.reshape(-1, 3), masks.den)
    sigma = sigma_of(den_feat)
    _, weight, _ = raw2alpha(sigma, dists * cfg.distance_scale)
    app_gate = weight > cfg.ray_march_weight_thres
    num_valid = torch.sum(app_gate.to(torch.int32))

    if top_k:
        # Appearance only for the top-K weights per ray: exact whenever K
        # covers every above-threshold sample.  torch.topk may order tied
        # weights differently from jax.lax.top_k; the render is the same.
        K = shade_top_k
        w_sel, idx = torch.topk(weight, K, dim=-1)
        xyz_sel = torch.take_along_dim(xyz_n, idx[..., None], dim=1).reshape(-1, 3)
        gate_sel = w_sel > cfg.ray_march_weight_thres
        if fused:
            app_feat_sel = field.app_feature_fused(xyz_sel, masks.app)
        else:
            app_feat_sel = field.app_feature(xyz_sel, masks.app)
        rgb_s = shade(xyz_sel, app_feat_sel.reshape(B * K, -1), K)
        rgb_s = torch.where(gate_sel[..., None], rgb_s, torch.zeros((), device=rays.device))
        rgb_map = torch.sum(w_sel[..., None] * rgb_s, dim=-2)
    else:
        if not fused:
            app_feat = field.app_feature(xyz_n.reshape(-1, 3), masks.app)
        rgb_s = shade(xyz_n.reshape(-1, 3), app_feat, N)
        rgb_s = torch.where(app_gate[..., None], rgb_s, torch.zeros((), device=rays.device))
        rgb_map = torch.sum(weight[..., None] * rgb_s, dim=-2)

    return _composite(
        rgb_map, weight, sigma, z_vals, rays, flip, num_valid,
        is_train=is_train, white_bg=white_bg, mean_alive_samples=mean_alive,
    )


def _composite(
    rgb_map, weight, sigma, z_vals, rays, flip, num_valid, *,
    is_train: bool, white_bg: bool, mean_alive_samples,
) -> RenderOutput:
    acc = torch.sum(weight, dim=-1)
    # White background; at train time a random 50% flip when the dataset
    # background is not white.
    if white_bg:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    elif is_train and flip is not None:
        rgb_map = rgb_map + flip * (1.0 - acc[..., None])
    rgb_map = torch.clamp(rgb_map, 0.0, 1.0)
    with torch.no_grad():
        depth = torch.sum(weight * z_vals, dim=-1) + (1.0 - acc) * rays[:, -1]
    return RenderOutput(
        rgb=rgb_map,
        depth=depth,
        acc=acc,
        weights=weight,
        sigma=sigma,
        z_vals=z_vals,
        num_valid_samples=num_valid,
        mean_alive_samples=mean_alive_samples,
    )
