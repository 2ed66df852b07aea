"""Training loop for the first schedule segment (counterpart of the setup
and first segment of tensorf_tpu/train/loop.py::reconstruction).

``train_steps`` parses nothing itself: it takes a TrainConfig, builds the
ray store, filters it by the scene bbox, initializes the field, takes
``n_steps`` train steps, then renders one test view in chunks with no
jitter and reports its PSNR.  Schedule events (upsample, alpha mask,
shrink), checkpoints, ray stratification, sample budgets and multi-device
runs are not ported yet; a config that sets stratification or a budget
raises NotImplementedError.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config.schema import TrainConfig, model_config_from
from ..data import dataset_dict
from ..models.config import GridGeometry, cal_n_samples, n_to_reso
from ..models.tensorf import FIELD_MODELS
from ..ops.freq_mask import FreeMasks
from ..render.culling import filter_rays_bbox
from ..render.volume import render_rays
from ..utils.device import resolve_device
from .losses import LossWeights
from .optim import make_optimizer
from .sampler import SimpleSampler
from .step import TrainStatics, make_train_step


class TrainResult(NamedTuple):
    total_loss: List[float]  # per step
    step_ms: float  # mean ms/step over steps 2..n (host clock, device synced at both ends)
    test_psnr: float
    test_rgb: np.ndarray  # (H, W, 3) rendered test view
    n_samples: int
    grid_size: Tuple[int, int, int]
    field: torch.nn.Module  # the trained field


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_segment_end(cfg: TrainConfig) -> int:
    """The iteration of the first schedule event (or n_iters without one)."""
    events = list(cfg.upsamp_list) + list(cfg.update_AlphaMask_list)
    return int(min(events)) if events else int(cfg.n_iters)


def _datasets(cfg: TrainConfig, scene: Optional[Dict[str, dict]]):
    if cfg.dataset_name not in dataset_dict:
        raise NotImplementedError(f"dataset {cfg.dataset_name!r} is not ported yet")
    cls = dataset_dict[cfg.dataset_name]
    extra = {}
    if scene is not None:
        h, w = scene["train"]["frames"][0]["image"].shape[:2]
        extra = {"wh": (w, h)}
    common = dict(downsample=cfg.downsample_train, **extra)
    train = cls(cfg.datadir, split="train", num_images=cfg.resolved_train_images(),
                meta=None if scene is None else scene["train"], **common)
    test = cls(cfg.datadir, split="test", num_images=cfg.resolved_test_images(),
               is_stack=True, meta=None if scene is None else scene["test"], **common)
    return train, test


@torch.no_grad()
def render_view(field, rays: torch.Tensor, *, chunk: int, **render_kw) -> torch.Tensor:
    """Deterministic (no jitter) render of (N, 6) rays in chunks -> (N, 3)."""
    out = [
        render_rays(field, rays[s : s + chunk], FreeMasks(), u=None, **render_kw).rgb
        for s in range(0, rays.shape[0], chunk)
    ]
    return torch.cat(out)


def train_steps(
    cfg: TrainConfig,
    n_steps: int,
    *,
    device=None,
    scene: Optional[Dict[str, dict]] = None,
    chunk: int = 4096,
    log: Callable[[str], None] = print,
    on_step: Optional[Callable[[int], None]] = None,
) -> TrainResult:
    """Train ``n_steps`` steps of the first segment, then render test view 0.

    ``scene`` is an in-memory dataset ({split: transforms dict with inline
    images}, see data/synthetic.py::make_synthetic_scene_arrays); None reads
    ``cfg.datadir`` from disk.  ``on_step(it)`` runs after each step is
    enqueued (profile_step.py brackets steps with it).
    """
    device = resolve_device(device)
    if cfg.ndc_ray:
        raise NotImplementedError("NDC rays are not ported yet")
    end = first_segment_end(cfg)
    if n_steps > end:
        raise ValueError(
            f"the port runs the first schedule segment only: n_steps={n_steps} "
            f"passes the first schedule event at iteration {end}"
        )
    # knobs of the JAX trainer not ported yet: a run that sets them would
    # compute something else than its config states
    unported = [k for k in ("stratify", "sample_budget", "prefilter_budget") if getattr(cfg, k)]
    if unported:
        raise NotImplementedError(
            f"not ported yet: {', '.join(unported)}; set "
            + ", ".join(f"{k}=0" for k in unported)
            + " to run without"
        )

    train_ds, test_ds = _datasets(cfg, scene)
    model_cfg = model_config_from(cfg).replace(
        near_far=tuple(float(v) for v in train_ds.near_far)
    )
    aabb_np = np.asarray(train_ds.scene_bbox, np.float32).reshape(2, 3)
    grid_size = n_to_reso(cfg.N_voxel_init, aabb_np)
    if cfg.model_name not in FIELD_MODELS:
        raise NotImplementedError(f"model {cfg.model_name!r} is not ported yet")
    field = FIELD_MODELS[cfg.model_name](
        model_cfg, grid_size, device, torch.Generator().manual_seed(cfg.seed)
    )
    geometry = GridGeometry.create(aabb_np, grid_size, cfg.step_ratio)
    n_samples = min(int(cfg.nSamples), cal_n_samples(grid_size, cfg.step_ratio))
    decay_iters = cfg.lr_decay_iters if cfg.lr_decay_iters > 0 else cfg.n_iters
    lr_factor = cfg.lr_decay_target_ratio ** (1 / decay_iters)
    optimizer = make_optimizer(field, cfg.lr_init, cfg.lr_basis, lr_factor)

    rays, rgbs = filter_rays_bbox(train_ds.all_rays, train_ds.all_rgbs, aabb_np, device)
    sampler = SimpleSampler(rays.shape[0], cfg.batch_size, cfg.seed)
    ratio = cfg.mask_ratio_list[0] if cfg.mask_ratio_list else 1.0
    statics = TrainStatics(
        n_samples=n_samples,
        step_size=geometry.step_size,
        white_bg=train_ds.white_bg,
        ndc_ray=False,
        total_steps=cfg.n_iters,
        lr_factor=lr_factor,
        weights=LossWeights(
            ortho=cfg.Ortho_weight if "VM" in cfg.model_name else 0.0,
            l1=cfg.L1_weight_inital,
            tv_density=cfg.TV_weight_density,
            tv_app=cfg.TV_weight_app,
            occ=cfg.occ_reg_loss_mult if (cfg.occ_reg or cfg.occ_reg_loss_mult > 0) else 0.0,
            occ_range=cfg.occ_reg_range,
            occ_wb_range=cfg.occ_wb_range,
            occ_wb_prior=bool(cfg.occ_wb_prior),
        ),
        free_reg=bool(cfg.free_reg),
        free_decomp=bool(cfg.free_decomp),
        freq_reg_ratio=float(cfg.freq_reg_ratio) * float(ratio),
        max_visible=cfg.max_vis_freq_ratio if cfg.max_vis_freq_ratio > 0 else None,
        # the first segment has no alpha mask: the pre-mask top-K applies
        shade_top_k=cfg.prefilter_shade_top_k if cfg.prefilter_shade_top_k > 0 else None,
        fused=bool(cfg.fused_gathers),
    )
    log(
        f"[port] {cfg.model_name} grid {grid_size} n_samples {n_samples} "
        f"batch {cfg.batch_size} store {rays.shape[0]} rays on {device}"
    )

    step_fn = make_train_step(field, statics, optimizer)
    noise = torch.Generator(device=device).manual_seed(cfg.seed)
    aabb = torch.as_tensor(aabb_np, device=device)
    totals = []
    t_first = None
    for it in range(n_steps):
        ids = sampler.nextids().to(device)
        metrics = step_fn(aabb, rays[ids], rgbs[ids], it, noise)
        totals.append(metrics["total_loss"])
        if it == 0:
            _sync(device)
            t_first = time.perf_counter()
        if on_step is not None:
            on_step(it)
    _sync(device)
    step_ms = (
        (time.perf_counter() - t_first) * 1e3 / (n_steps - 1) if n_steps > 1 else math.nan
    )
    totals = torch.stack(totals).tolist() if totals else []
    for it in range(0, n_steps, max(int(cfg.progress_refresh_rate), 1)):
        log(f"[port] iter {it}: loss {totals[it]:.6f}")

    W, H = test_ds.img_wh
    rgb = render_view(
        field,
        torch.as_tensor(test_ds.all_rays[0], device=device),
        chunk=chunk,
        aabb=aabb,
        step_size=geometry.step_size,
        n_samples=n_samples,
        is_train=False,
        white_bg=test_ds.white_bg,
        shade_top_k=cfg.shade_top_k if cfg.shade_top_k > 0 else None,
        fused=bool(cfg.fused_gathers),
    ).reshape(H, W, 3).cpu().numpy()
    gt = np.asarray(test_ds.all_rgbs[0], np.float32)
    test_psnr = float(-10.0 * np.log10(np.mean((rgb - gt) ** 2)))
    log(f"[port] test view 0 psnr {test_psnr:.3f}")
    return TrainResult(
        total_loss=totals,
        step_ms=step_ms,
        test_psnr=test_psnr,
        test_rgb=rgb,
        n_samples=n_samples,
        grid_size=tuple(grid_size),
        field=field,
    )
