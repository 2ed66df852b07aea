"""The training loop (counterpart of tensorf_tpu/train/loop.py).

``reconstruction`` runs a config's whole coarse-to-fine schedule: the
alpha-mask events (shrink to the tight bbox at the first, alpha-based ray
re-filtering at the second, the L1 weight switch), the voxel upsamples
(with an optimizer reset at every shape change), the periodic and final
``.npz`` checkpoints and the test-set evaluations.  ``render_test`` is the
render-only entry on a checkpoint; ``train_steps`` takes a few steps of
the first segment and renders one view (profile_step.py uses it).

Each event is a function of a ``TrainState`` (``alpha_mask_event``,
``upsample_event``, ``restratify``, ``raise_budgets``), so the tests can
hold it against the JAX loop's own event code.  After every event the ray
store is re-partitioned by per-ray candidate count (``stratify``): each
stratum is drawn at a fixed quota and rendered at its own sample budget
and lattice, and a budget that keeps overflowing is raised.  The
evaluations serve stratified (``stratify_render``): rays sorted by
candidate count and rendered per budget tier, exact by construction.
After training, ``render_train``, ``render_test`` and ``render_path``
render the train split, the test split and the dataset's trajectory (if it
has one); ``export_mesh`` turns a checkpoint's alpha grid into a ``.ply``.

``resume`` continues a run in its logfolder from the newest resumable
checkpoint: every periodic and final checkpoint carries the iteration,
the schedule position, the budgets, the optimizer state (in the JAX
package's ``opt/`` leaf layout, so a checkpoint resumes in either package),
the sampler state and the history rows.  Per-step noise is stateless (a
generator seeded from (seed, iteration), ``step_seed``), so a resumed run
on the CPU replays the uninterrupted run bit for bit.  A ``Watchdog``
armed before any device work exits the process resumable (code 17) when
the run stops making progress.  The run writes ``history.npz`` (a row
every ``train_vis_every`` steps), tensorboard scalars when tensorboardX
imports, and with ``save_images`` the progress figures and their GIF.
A config with ``ndc_ray`` (the forward-facing LLFF scenes) trains as the
JAX loop trains it: its ray store is neither bbox-filtered nor re-filtered
by the mask, it is never stratified, its mask gates exactly (no coarse
pre-gate), and it serves uniform.

``n_devices`` and ``distributed`` run the schedule data-parallel over
ranks, as the JAX loop runs it over a device mesh (parallel/).  With
``n_devices`` N (0: every visible card) ``reconstruction`` spawns one rank
per card; every rank draws the same global batch and renders its block of
it.  With ``distributed`` the ranks come from the environment (torchrun or
the JAX package's TFTPU_* variables), each drawing its share of the batch
from its own id pool with its own sampler seed and its slice of the global
stratum plan.  Either way every rank holds the whole field, the step sums
the gradients over the ranks, the parameters are broadcast from rank 0
after every event that rebuilds them, the evaluations render each frame's
chunks split over the ranks, the decisions (budget raises, resume) read
reduced values, and rank 0 alone writes the logfolder's files.

``profile_dir`` has ``reconstruction`` write a ``torch.profiler`` Chrome trace
of ``profile_steps`` steps from ``profile_start`` and log the sample-slot use
those steps counted (``_ProfileWindow``, utils/tracing.py).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import shutil
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config.schema import TrainConfig, model_config_from
from ..convert import optimizer_from_jax, optimizer_to_jax
from ..data import dataset_dict
from ..eval.evaluation import RendererHandle, evaluation, evaluation_path, psnrs_calculate
from ..eval.mesh import PlyMesh, convert_alpha_samples_to_ply, native_available
from ..eval.vis import create_gif, save_rendered_image_per_train
from ..models.alpha_mask import coarse_gate_valid
from ..models.config import GridGeometry, cal_n_samples, n_to_reso, n_voxel_schedule
from ..models.tensorf import FIELD_MODELS
from ..ops.freq_mask import free_masks
from ..parallel.launch import join_from_env, rank_devices, spawn
from ..parallel.mesh import (
    RankGroup,
    barrier,
    broadcast_params,
    broadcast_tensors,
    destroy_group,
    host_allmax,
    host_ray_pool,
    is_writer,
    param_digest,
    shard_rows,
)
from ..render.culling import (
    _budget_hint,
    count_ray_candidates,
    count_ray_candidates_and_alive,
    count_ray_candidates_and_chord,
    compute_alpha_grid,
    count_ray_inbbox,
    filter_rays_alpha,
    filter_rays_bbox,
    stratify_rays,
    stratify_rays_joint,
    update_alpha_mask,
)
from ..utils import tracing
from ..utils.ckpt import load_aux, load_checkpoint, load_opt_leaves, save_checkpoint
from ..utils.cuda_build import BUILD_DIR
from ..utils.device import resolve_device
from ..utils.watchdog import Watchdog
from .losses import LossWeights
from .optim import make_optimizer
from .sampler import SimpleSampler, StratifiedSampler, allocate_quotas, localize_strata
from .step import TrainStatics, make_train_step, render_widths

def quota_round(n_dev: int) -> int:
    """Per-stratum quotas are multiples of this: the smallest multiple of
    the device count that is >= 8 (the JAX loop's rounding), so every
    quota splits evenly over the ranks."""
    return n_dev * -(-8 // n_dev)


def step_seed(seed: int, iteration: int) -> int:
    """The seed of iteration ``iteration``'s noise generator: a function of
    (seed, iteration) alone, as the JAX loop's fold_in(base_key, iteration)
    is, so a resumed run draws the noise an uninterrupted run draws."""
    return int(np.random.SeedSequence([int(seed), int(iteration)]).generate_state(1, np.uint64)[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_segment_end(cfg: TrainConfig) -> int:
    """The iteration of the first schedule event (or n_iters without one)."""
    events = list(cfg.upsamp_list) + list(cfg.update_AlphaMask_list)
    return int(min(events)) if events else int(cfg.n_iters)


def _dataset(cfg: TrainConfig, scene: Optional[dict], split: str, **kw):
    """``split`` of the config's dataset: read from ``cfg.datadir``, or from
    the in-memory ``scene`` — blender-layout splits ({split: transforms
    dict}) or an LLFF capture ({"poses_bounds", "images"})."""
    if cfg.dataset_name not in dataset_dict:
        raise ValueError(f"unknown dataset {cfg.dataset_name!r}")
    extra = {}
    if scene is not None and "poses_bounds" in scene:
        extra = {"meta": scene}
    elif scene is not None:
        h, w = scene["train"]["frames"][0]["image"].shape[:2]
        extra = {"wh": (w, h), "meta": scene[split]}
    return dataset_dict[cfg.dataset_name](cfg.datadir, split=split,
                                          downsample=cfg.downsample_train, **extra, **kw)


def _datasets(cfg: TrainConfig, scene: Optional[Dict[str, dict]]):
    train = _dataset(cfg, scene, "train", num_images=cfg.resolved_train_images())
    test = _dataset(cfg, scene, "test", num_images=cfg.resolved_test_images(), is_stack=True)
    return train, test


def _render_after_training(cfg: TrainConfig, scene, handle: RendererHandle, test_ds,
                           folder: str, save_images: bool, log, heartbeat=None) -> List[float]:
    """The renders after training or from a checkpoint (tensorf_tpu
    loop.py:1375-1408 and 1465-1487): ``render_train`` every train view
    (all of the split, stacked) into imgs_train_all/, ``render_test`` the
    test split into imgs_test_all/, ``render_path`` the test dataset's
    trajectory, where it has one, into imgs_path_all/.  Images are written
    only with ``save_images``; ``heartbeat`` runs once per rendered image.
    Returns the test PSNRs."""
    def save(sub):
        return f"{folder}/{sub}/" if save_images else None

    if cfg.render_train:
        psnrs = evaluation(_dataset(cfg, scene, "train", is_stack=True), handle,
                           save("imgs_train_all"), heartbeat=heartbeat)
        log(f"======> {cfg.expname} train all psnr: {np.mean(psnrs)} <========")
    psnrs = []
    if cfg.render_test:
        psnrs = evaluation(test_ds, handle, save("imgs_test_all"), heartbeat=heartbeat)
        if psnrs:
            log(f"======> {cfg.expname} test all psnr: {np.mean(psnrs)} <========")
    if cfg.render_path and hasattr(test_ds, "render_path"):
        evaluation_path(test_ds, handle, test_ds.render_path, save("imgs_path_all"),
                        heartbeat=heartbeat)
    return psnrs


class TrainState:
    """What the schedule carries from segment to segment: the field and its
    optimizer, the mask, the grid geometry and lattice, the ray store and
    its sampler, and the loss and LR settings of the current segment."""

    def __init__(self, cfg: TrainConfig, device: torch.device, scene=None,
                 group: Optional[RankGroup] = None):
        """With ``cfg.ckpt_path`` the state starts from that checkpoint's
        field, grid, aabb and mask.  With ``cfg.resume`` too, and a
        resumable checkpoint, it continues that run (``resume_extra`` then
        holds the checkpoint's ``extra``): its lattice, LR scale, loss and
        budget settings, the upsamples still ahead, and the ray store as the
        run had it (filtered on the dataset's bbox, re-filtered by the mask
        once past the second mask event).  The optimizer state and the
        sampler are restored apart (``restore_optimizer``,
        ``restore_sampling_state``).  ``group``: this rank's place in a
        data-parallel run (None: one rank)."""
        self.cfg = cfg
        self.device = device
        self.group = group
        self.world = self.group.world if self.group else 1
        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} must divide by the {self.world} ranks")
        self.ndc_ray = bool(cfg.ndc_ray)
        self.train_ds, self.test_ds = _datasets(cfg, scene)
        self.white_bg = self.train_ds.white_bg
        self.near_far = tuple(float(v) for v in self.train_ds.near_far)
        scene_aabb = np.asarray(self.train_ds.scene_bbox, np.float32).reshape(2, 3)
        aabb = scene_aabb
        self.alpha_mask = None
        resume_extra = None
        if cfg.ckpt_path:
            # restart from a checkpoint: its field, grid, aabb and mask
            _, self.field, aabb, grid_size, self.alpha_mask, ck_extra = load_checkpoint(
                cfg.ckpt_path, device
            )
            print(f"resumed from {cfg.ckpt_path} (grid {grid_size})")
            if cfg.resume and ck_extra and "iteration" in ck_extra:
                resume_extra = ck_extra
        else:
            if cfg.model_name not in FIELD_MODELS:
                raise ValueError(f"unknown model {cfg.model_name!r}")
            model_cfg = model_config_from(cfg).replace(near_far=self.near_far)
            grid_size = n_to_reso(cfg.N_voxel_init, aabb)
            self.field = FIELD_MODELS[cfg.model_name](
                model_cfg, grid_size, device, torch.Generator().manual_seed(cfg.seed)
            )
        self.resume_extra = resume_extra
        extra = resume_extra or {}
        self.start_iter = int(extra["iteration"]) + 1 if resume_extra is not None else 0
        self.geometry = GridGeometry.create(aabb, grid_size, cfg.step_ratio)
        # n_samples is not derivable from the grid alone (a shrink changes
        # the geometry without it): a resume restores the saved value
        self.n_samples = int(extra.get(
            "n_samples", min(int(cfg.nSamples), cal_n_samples(grid_size, cfg.step_ratio))))
        self.n_voxel_list = n_voxel_schedule(cfg.N_voxel_init, cfg.N_voxel_final,
                                             len(cfg.upsamp_list))
        # the upsamples already applied
        self.n_voxel_list = self.n_voxel_list[
            sum(1 for i in cfg.upsamp_list if i < self.start_iter):]
        decay_iters = cfg.lr_decay_iters if cfg.lr_decay_iters > 0 else cfg.n_iters
        self.lr_factor = cfg.lr_decay_target_ratio ** (1 / decay_iters)
        self.reset_optimizer(float(extra.get("lr_scale", 1.0)))
        self.l1_weight = float(extra.get("l1_weight", cfg.L1_weight_inital))
        self.ratio = float(extra.get("ratio", cfg.mask_ratio_list[0] if cfg.mask_ratio_list
                                     else 1.0))
        if self.ndc_ray:
            # NDC rays start on the near plane, inside the box: the JAX
            # loop keeps the whole split
            self.rays = torch.as_tensor(np.asarray(self.train_ds.all_rays, np.float32),
                                        device=device)
            self.rgbs = torch.as_tensor(np.asarray(self.train_ds.all_rgbs, np.float32),
                                        device=device)
        else:
            # a resume filters on the dataset's bbox, as the run did before
            # any shrink; a ckpt_path restart filters on the checkpoint's
            self.rays, self.rgbs = filter_rays_bbox(
                self.train_ds.all_rays, self.train_ds.all_rgbs,
                scene_aabb if resume_extra is not None else aabb, device
            )
        if (resume_extra is not None and not self.ndc_ray and self.alpha_mask is not None
                and len(cfg.update_AlphaMask_list) > 1
                and self.start_iter > cfg.update_AlphaMask_list[1]):
            # the run re-filtered its store at the second mask event
            self.rays, self.rgbs = filter_rays_alpha(
                self.rays, self.rgbs, self.alpha_mask, self.geometry.aabb_np,
                self.geometry.step_size, self.near_far,
            )
            print(f"[resume] store re-filtered to {self.rays.shape[0]} rays")
        self.sampler = self.simple_sampler(self.start_iter)
        # the budgets in effect, each auto-raised when it keeps overflowing:
        # the unstratified mask-era and prefilter budgets, and with strata
        # (None = unstratified) one candidate budget, alive budget, lattice
        # cap, store-share loss weight and quota per stratum
        self.run_budget = int(extra.get("run_budget", max(int(cfg.sample_budget), 0)))
        self.prefilter_run = int(extra.get("prefilter_run", max(int(cfg.prefilter_budget), 0)))
        self.strata_budgets: Optional[list] = None
        self.strata_alive_budgets: Optional[list] = None
        self.strata_n_samples: Optional[tuple] = None
        self.strata_loss_w: Optional[list] = None
        self.quotas: Optional[list] = None
        self.overflow_strikes = [0]

    @property
    def pooled(self) -> bool:
        """Each rank draws its share of the batch from its own id pool (a
        distributed run); else every rank draws the global batch."""
        return self.group is not None and self.group.pooled

    def ray_pool(self) -> Optional[np.ndarray]:
        """This rank's id pool over the current store (None: the whole)."""
        if not self.pooled:
            return None
        pool, _ = host_ray_pool(self.rays.shape[0], self.cfg.batch_size, self.group.rank,
                                self.world)
        return np.arange(self.rays.shape[0], dtype=np.int64) if pool is None else pool

    def simple_sampler(self, iteration: int) -> SimpleSampler:
        """The plain sampler from ``iteration`` on: over this rank's pool,
        drawing its share of the batch, seeded apart per rank (the JAX
        loop's ``seed + iteration + process_index``), on a distributed run;
        the global batch at ``seed + iteration`` otherwise."""
        if not self.pooled:
            return SimpleSampler(self.rays.shape[0], self.cfg.batch_size,
                                 self.cfg.seed + iteration)
        return SimpleSampler(self.rays.shape[0], self.cfg.batch_size // self.world,
                             self.cfg.seed + iteration + self.group.rank, pool=self.ray_pool())

    def broadcast(self) -> None:
        """Rank 0's parameters and mask on every rank (after an event
        rebuilds them, as the JAX loop re-replicates)."""
        broadcast_params(self.field, self.group)
        m = self.alpha_mask
        if self.group is not None and m is not None:
            broadcast_tensors([t for t in (m.volume, m.dilated, m.coarse) if t is not None],
                              self.group)

    @property
    def aabb(self) -> torch.Tensor:
        return torch.as_tensor(self.geometry.aabb_np, device=self.device)

    def coarse_ok(self) -> bool:
        return coarse_gate_valid(self.alpha_mask, self.geometry.step_size, self.ndc_ray)

    def active_budget(self) -> Optional[int]:
        """The unstratified budget of the current phase: sample_budget once
        the mask exists, prefilter_budget before; None where it would not
        cut the lattice."""
        b = self.run_budget if self.alpha_mask is not None else self.prefilter_run
        return b if 0 < b < self.n_samples else None

    def next_ids(self):
        """The next batch's store ids on the device: one tensor, or with
        strata one per stratum (one upload, split on the device)."""
        with tracing.span("tftorch.train.sample"):
            ids = self.sampler.nextids()
            if self.group is not None and not self.pooled:
                # every rank drew the global batch: this rank's block of each
                # sub-batch
                rank = self.group.rank
                ids = (tuple(shard_rows(i, rank, self.world) for i in ids)
                       if isinstance(ids, tuple) else shard_rows(ids, rank, self.world))
            flat = torch.cat(ids) if isinstance(ids, tuple) else ids
            if self.device.type == "cuda":
                # from pinned memory the upload does not wait for the device
                flat = flat.pin_memory().to(self.device, non_blocking=True)
            if isinstance(ids, tuple):
                return torch.split(flat, [len(i) for i in ids])
            return flat

    def drop_optimizer(self) -> None:
        """Free the Adam state and the gradients before the factors change
        shape (at 300^3 they are the size of the field twice over)."""
        self.optimizer = None
        self.field.zero_grad(set_to_none=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reset_optimizer(self, lr_scale: float) -> None:
        self.lr_scale = lr_scale
        self.optimizer = make_optimizer(
            self.field, self.cfg.lr_init * lr_scale, self.cfg.lr_basis * lr_scale, self.lr_factor
        )

    def restore_optimizer(self, leaves, log: Callable[[str], None] = print) -> bool:
        """Load a resumable checkpoint's ``opt/`` leaves (either package's)
        into the fresh optimizer: the moments, the step count and the LR
        decay's position.  A mismatch keeps the fresh optimizer."""
        if leaves is None:
            return False
        try:
            optimizer_from_jax(self.optimizer, self.field, leaves)
        except ValueError as e:
            log(f"[resume] optimizer state mismatch — reinitialized ({e})")
            return False
        log("[resume] optimizer state restored")
        return True

    def restore_sampling_state(self, extra: dict, aux: Dict[str, np.ndarray],
                               log: Callable[[str], None] = print) -> bool:
        """Restore the stratification plan and the sampler's state from a
        resumable checkpoint of the port, so the resumed run draws the ids
        the uninterrupted run draws.  Returns False (the caller
        restratifies) when the checkpoint has no such state; a JAX
        checkpoint's sampler state is numpy's and does not carry over.  A
        distributed run restratifies too, as the JAX loop does: rank 0's
        checkpoint holds rank 0's sampler only."""
        meta = extra.get("port_sampler")
        if self.pooled:
            return False
        if not meta:
            if extra.get("sampler"):
                log("[resume] sampling-state restore failed (the checkpoint holds the "
                    "JAX package's numpy sampler state); restratifying instead")
            return False
        arrays = {k[len("port_sampler/"):]: v for k, v in aux.items()
                  if k.startswith("port_sampler/")}
        try:
            if meta["kind"] == "stratified":
                sampler = StratifiedSampler.from_state(meta, arrays)
                if any(s.numel() and int(s.max()) >= self.rays.shape[0] for s in sampler.strata):
                    raise ValueError("saved strata exceed the ray store")
                if sum(sampler.quotas) != self.cfg.batch_size:
                    raise ValueError("saved quotas do not sum to the batch")
            else:
                sampler = self.simple_sampler(0)
                sampler.set_state(meta, arrays)
        except (KeyError, ValueError) as e:
            log(f"[resume] sampling-state restore failed ({e}); restratifying instead")
            return False
        self.sampler = sampler
        stratified = meta["kind"] == "stratified"
        self.strata_budgets = extra.get("strata_budgets")
        self.strata_alive_budgets = extra.get("strata_alive_budgets")
        sns = extra.get("strata_n_samples")
        self.strata_n_samples = tuple(sns) if sns else None
        self.strata_loss_w = extra.get("strata_loss_w")
        self.quotas = list(sampler.quotas) if stratified else None
        self.overflow_strikes = list(extra.get("overflow_strikes", [0]))
        log(f"[resume] sampling state restored ({meta['kind']})")
        return True


def build_statics(state: TrainState) -> TrainStatics:
    """The step's statics for the current segment (tensorf_tpu
    loop.py:526-609)."""
    cfg = state.cfg
    if state.alpha_mask is not None:
        # top-K shading once the mask concentrates the weights on surfaces
        top_k = cfg.shade_top_k if cfg.shade_top_k > 0 else None
    else:
        top_k = cfg.prefilter_shade_top_k if cfg.prefilter_shade_top_k > 0 else None
    return TrainStatics(
        n_samples=state.n_samples,
        step_size=state.geometry.step_size,
        white_bg=state.white_bg,
        ndc_ray=state.ndc_ray,
        total_steps=cfg.n_iters,
        lr_factor=state.lr_factor,
        weights=LossWeights(
            ortho=cfg.Ortho_weight if "VM" in cfg.model_name else 0.0,
            l1=state.l1_weight,
            tv_density=cfg.TV_weight_density,
            tv_app=cfg.TV_weight_app,
            occ=cfg.occ_reg_loss_mult if (cfg.occ_reg or cfg.occ_reg_loss_mult > 0) else 0.0,
            occ_range=cfg.occ_reg_range,
            occ_wb_range=cfg.occ_wb_range,
            occ_wb_prior=bool(cfg.occ_wb_prior),
        ),
        free_reg=bool(cfg.free_reg),
        free_decomp=bool(cfg.free_decomp),
        freq_reg_ratio=float(cfg.freq_reg_ratio) * float(state.ratio),
        max_visible=cfg.max_vis_freq_ratio if cfg.max_vis_freq_ratio > 0 else None,
        shade_top_k=top_k,
        fused=bool(cfg.fused_gathers),
        sample_budget=state.active_budget(),
        use_coarse_gate=state.coarse_ok(),
        strata_budgets=None if state.strata_budgets is None else tuple(state.strata_budgets),
        strata_alive_budgets=(None if state.strata_alive_budgets is None
                              else tuple(state.strata_alive_budgets)),
        strata_n_samples=state.strata_n_samples,
        strata_loss_weights=None if state.strata_loss_w is None else tuple(state.strata_loss_w),
        strata_noise_match=bool(cfg.stratify_noise_match),
    )


def make_handle(state: TrainState) -> RendererHandle:
    cfg = state.cfg
    return RendererHandle(
        field=state.field,
        alpha_mask=state.alpha_mask,
        aabb=state.aabb,
        step_size=state.geometry.step_size,
        n_samples=state.n_samples,
        white_bg=state.white_bg,
        ndc_ray=state.ndc_ray,
        shade_top_k=cfg.shade_top_k if cfg.shade_top_k > 0 else None,
        fused=bool(cfg.fused_gathers),
        # the uniform eval path renders at the mask era's budget; stratified
        # serving has its own per-bucket budgets
        sample_budget=state.active_budget() if state.alpha_mask is not None else None,
        use_coarse_gate=state.coarse_ok(),
        # NDC rays serve uniform: the count passes march the non-NDC slab
        stratified=bool(cfg.stratify_render) and not state.ndc_ray,
        # evaluations split every frame's chunks over the training's ranks
        group=state.group,
    )


def restratify(state: TrainState, iteration: int, log: Callable[[str], None] = print
               ) -> Optional[dict]:
    """(Re)partition the ray store by per-ray candidate count and swap in
    the stratified sampler and the per-stratum budgets, lattices and loss
    weights (tensorf_tpu loop.py:611-812).  Returns the plan, or None when
    the run goes unstratified (the plain sampler then draws)."""
    with tracing.span("tftorch.train.restratify"):
        return _restratify(state, iteration, log)


def _restratify(state: TrainState, iteration: int, log: Callable[[str], None]
                ) -> Optional[dict]:
    cfg = state.cfg
    n_samples = state.n_samples
    count_args = (state.geometry.aabb_np, state.geometry.step_size, state.near_far)

    def deactivate():
        # a stale stratified sampler must never outlive its plan
        if state.strata_budgets is not None:
            state.strata_budgets = state.strata_alive_budgets = None
            state.strata_n_samples = state.strata_loss_w = state.quotas = None
            state.overflow_strikes = [0]
            state.sampler = state.simple_sampler(iteration)
        return None

    if not cfg.stratify or state.ndc_ray:
        return deactivate()
    alive_counts = None
    if state.alpha_mask is None:
        # before the first mask every in-bbox sample is alive: the chord is
        # the candidate count, and the capped lattice alone does the
        # compaction
        if not cfg.stratify_prefilter:
            return deactivate()
        counts = count_ray_inbbox(state.rays, *count_args, n_samples=n_samples)
        chord_counts = counts
    elif state.coarse_ok():
        if cfg.stratify_alive:
            counts, alive_counts, chord_counts = count_ray_candidates_and_alive(
                state.rays, state.alpha_mask, *count_args, n_samples=n_samples)
        else:
            # the probe-only pass: no (B, N, 3) lattice
            counts, chord_counts = count_ray_candidates_and_chord(
                state.rays, state.alpha_mask, *count_args, n_samples=n_samples)
    else:
        # the step selects with the exact gate: one stage, no lattice caps
        counts = count_ray_candidates(state.rays, state.alpha_mask, *count_args,
                                      n_samples=n_samples, use_coarse=False)
        chord_counts = None
    quantiles = tuple(cfg.strata_quantiles) if cfg.strata_quantiles else None
    if state.pooled:
        # the alive-primary joint plan is a one-process tool in the JAX loop
        alive_counts = None
    if alive_counts is not None:
        strata, budgets, alive_hints = stratify_rays_joint(counts, alive_counts,
                                                           quantiles=quantiles)
    else:
        strata, budgets = stratify_rays(counts, quantiles=quantiles)
        alive_hints = None
    sizes = [int(sel.size) for sel in strata]
    rounding = quota_round(state.world)
    if len(strata) * rounding > cfg.batch_size:
        log(f"[{iteration}] stratify skipped (batch too small)")
        return deactivate()
    # the GLOBAL quotas, each a multiple of the rank count
    quotas = allocate_quotas(sizes, cfg.batch_size, rounding)
    state.strata_budgets = [b if b < n_samples else None for b in budgets]
    state.strata_n_samples = None if chord_counts is None else tuple(
        min(n_samples, _budget_hint(int(chord_counts[sel].max()))) for sel in strata)
    state.strata_alive_budgets = None
    if alive_hints is not None:
        alive = [a if (a is not None and b is not None and a < b) else None
                 for a, b in zip(alive_hints, state.strata_budgets)]
        state.strata_alive_budgets = alive if any(a is not None for a in alive) else None
    state.overflow_strikes = [0] * len(strata)
    state.strata_loss_w = [n / float(sum(sizes)) for n in sizes]
    state.quotas = quotas
    if state.pooled:
        # rank r draws quota / W per stratum from its pool's slice of the
        # global plan
        rank = state.group.rank
        state.sampler = StratifiedSampler(
            localize_strata(strata, counts, state.ray_pool(), n_samples),
            [q // state.world for q in quotas], cfg.seed + iteration + rank)
    else:
        state.sampler = StratifiedSampler(strata, quotas, cfg.seed + iteration)
    plan = dict(event="stratify", iteration=iteration, sizes=sizes, quotas=quotas,
                budgets=list(state.strata_budgets), alive_budgets=state.strata_alive_budgets,
                lattices=None if state.strata_n_samples is None else list(state.strata_n_samples),
                lattice=n_samples, mean_count=float(np.mean(counts)),
                p999_count=float(np.quantile(counts, 0.999)),
                mean_alive=None if alive_counts is None else float(np.mean(alive_counts)))
    log(f"[{iteration}] stratified ray store: sizes {sizes}, quotas {quotas}, budgets "
        f"{plan['budgets']}, alive budgets {plan['alive_budgets']}, lattices {plan['lattices']} "
        f"(lattice {n_samples}, mean cand {plan['mean_count']:.1f}, "
        f"p99.9 {plan['p999_count']:.0f})")
    return plan


def _ceil32(b: int) -> int:
    return int(np.ceil(b * 1.5 / 32) * 32)


def raise_budgets(state: TrainState, per_budget, iteration: int,
                  log: Callable[[str], None] = print) -> List[str]:
    """Overflow bookkeeping at a progress read (tensorf_tpu
    loop.py:1046-1136): a budget whose overflow exceeds 1% of the rays at
    two reads in a row is raised to ceil32(1.5 b) — per stratum with
    strata (dropped to unbudgeted once it reaches the lattice), else the
    phase's own budget (capped at the lattice).  Returns what was raised;
    the caller rebuilds the step when it is not empty."""
    per_budget = [float(o) for o in per_budget]
    if len(state.overflow_strikes) != len(per_budget):
        state.overflow_strikes = [0] * len(per_budget)
    strikes = state.overflow_strikes
    raised = []
    for s, o in enumerate(per_budget):
        if not o > 0.01:
            strikes[s] = 0
            continue
        strikes[s] += 1
        where = (f"stratum {s}, budget {state.strata_budgets[s]}"
                 if state.strata_budgets is not None
                 else f"budget {state.run_budget if state.alpha_mask is not None else state.prefilter_run}")
        log(f"[budget] overflow on {o:.1%} of rays at iteration {iteration} ({where})")
        if strikes[s] < 2:
            continue
        strikes[s] = 0
        if state.strata_budgets is not None:
            b = state.strata_budgets[s]
            if b:
                nb = _ceil32(b)
                state.strata_budgets[s] = nb if nb < state.n_samples else None
                raised.append(f"stratum {s} -> {state.strata_budgets[s]}")
            # the stratum's overflow counts both stages: raise the alive cap
            # alongside (dropped once it no longer undercuts the budget)
            alive = state.strata_alive_budgets
            if alive is not None and alive[s]:
                na, cb = _ceil32(alive[s]), state.strata_budgets[s]
                alive[s] = na if (cb is not None and na < cb) else None
                if not any(a is not None for a in alive):
                    state.strata_alive_budgets = None
                raised.append(f"stratum {s} alive -> {alive[s]}")
        elif state.alpha_mask is not None and 0 < state.run_budget < state.n_samples:
            state.run_budget = min(state.n_samples, _ceil32(state.run_budget))
            raised.append(f"sample_budget -> {state.run_budget}")
        elif state.alpha_mask is None and 0 < state.prefilter_run < state.n_samples:
            state.prefilter_run = min(state.n_samples, _ceil32(state.prefilter_run))
            raised.append(f"prefilter_budget -> {state.prefilter_run}")
    if raised:
        log(f"[budget] auto-raised {', '.join(raised)} at iteration {iteration}")
    return raised


def alpha_mask_event(state: TrainState, iteration: int) -> dict:
    """The alpha-mask event at ``iteration`` (tensorf_tpu loop.py:1196-1304):
    rebuild the mask; at the first event shrink the factors to the tight
    bbox and reset the optimizer; at the second re-filter the ray store by
    the mask; switch the L1 weight to ``L1_weight_rest``."""
    cfg, field = state.cfg, state.field
    gs = state.geometry.grid_size
    # the mask lattice is the grid, capped at 256 per axis above 256^3
    reso_mask = gs if int(np.prod(gs)) < 256**3 else tuple(min(g, 256) for g in gs)
    den_mask = None
    if cfg.free_reg and cfg.free_decomp:
        mc = field.cfg
        den_mask = free_masks(
            mc.pos_bit_length, mc.view_bit_length, mc.fea_bit_length,
            mc.density_n_comp, mc.app_n_comp, iteration, cfg.n_iters,
            float(cfg.freq_reg_ratio) * float(state.ratio), device=state.device,
        ).den
    state.alpha_mask, new_aabb, occupancy = update_alpha_mask(
        field, state.alpha_mask, state.geometry.aabb_np, reso_mask,
        state.geometry.step_size, den_mask,
    )
    record = dict(event="alpha_mask", iteration=iteration, occupancy=occupancy,
                  mask_reso=tuple(int(r) for r in reso_mask), tight_aabb=new_aabb.tolist())
    if iteration == cfg.update_AlphaMask_list[0]:
        # shrink to the tight bbox, voxel-aligned (tensoRF.py:290-327)
        old = state.geometry
        units = old.units
        t_l = np.round(np.round((new_aabb[0] - old.aabb_np[0]) / units)).astype(np.int64)
        b_r = np.round((new_aabb[1] - old.aabb_np[0]) / units).astype(np.int64) + 1
        b_r = np.minimum(b_r, np.asarray(old.grid_size))
        state.drop_optimizer()
        field.shrink(tuple(t_l.tolist()), tuple(b_r.tolist()))
        gs_arr = np.asarray(old.grid_size, np.float64)
        t_l_r = t_l / (gs_arr - 1)
        b_r_r = (b_r - 1) / (gs_arr - 1)
        corrected = np.stack([
            (1 - t_l_r) * old.aabb_np[0] + t_l_r * old.aabb_np[1],
            (1 - b_r_r) * old.aabb_np[0] + b_r_r * old.aabb_np[1],
        ])
        new_size = tuple((b_r - t_l).tolist())
        # n_samples stays: only an upsample recomputes it
        state.geometry = GridGeometry.create(corrected, new_size, cfg.step_ratio)
        state.reset_optimizer(1.0)
        record.update(shrink_grid=new_size)
    if (not state.ndc_ray and len(cfg.update_AlphaMask_list) > 1
            and iteration == cfg.update_AlphaMask_list[1]):
        # n_samples 256, the reference's default, not the step's lattice
        state.rays, state.rgbs = filter_rays_alpha(
            state.rays, state.rgbs, state.alpha_mask, state.geometry.aabb_np,
            state.geometry.step_size, state.near_far,
        )
        state.sampler = state.simple_sampler(iteration)
        record.update(refiltered=True)
    if state.l1_weight != cfg.L1_weight_rest and cfg.L1_weight_rest >= 0:
        state.l1_weight = cfg.L1_weight_rest
    record.update(_summary(state))
    return record


def upsample_event(state: TrainState, iteration: int) -> dict:
    """The voxel-upsample event at ``iteration`` (tensorf_tpu
    loop.py:1307-1338): the next voxel count of the schedule on the current
    aabb, a new lattice, the factors resized, the optimizer reset."""
    cfg = state.cfg
    if len(cfg.upsamp_list) == len(cfg.mask_ratio_list):
        state.ratio = cfg.mask_ratio_list[cfg.upsamp_list.index(iteration)]
    n_voxels = state.n_voxel_list.pop(0)
    new_grid = n_to_reso(n_voxels, state.geometry.aabb_np)
    state.n_samples = min(int(cfg.nSamples), cal_n_samples(new_grid, cfg.step_ratio))
    state.drop_optimizer()
    state.field.upsample(new_grid)
    state.geometry = GridGeometry.create(state.geometry.aabb_np, new_grid, cfg.step_ratio)
    if cfg.lr_upsample_reset:
        lr_scale = 1.0
    else:
        lr_scale = cfg.lr_decay_target_ratio ** (iteration / cfg.n_iters)
    state.reset_optimizer(lr_scale)
    return dict(event="upsample", iteration=iteration, n_voxels=n_voxels, **_summary(state))


def _summary(state: TrainState) -> dict:
    return dict(grid=tuple(state.geometry.grid_size), aabb=state.geometry.aabb_np.tolist(),
                n_samples=state.n_samples, store=int(state.rays.shape[0]),
                lr_scale=state.lr_scale, l1_weight=state.l1_weight)


def _make_logfolder(cfg: TrainConfig, log: Callable[[str], None] = print,
                    group: Optional[RankGroup] = None) -> str:
    """basedir/<YYYY-MM-DD>/<expname>, the date in Asia/Ho_Chi_Minh as the
    reference writes it (train.py:193-200), with the imgs_vis, imgs_rgba
    and rgba subfolders; emptied first on ``overwrt`` unless resuming.  A
    resume relaunched after local midnight continues in the newest prior
    folder of the expname (tensorf_tpu loop.py:92-122).  On several ranks
    rank 0 prepares it first (it may empty it) and the others follow it
    past a barrier without emptying it (tensorf_tpu loop.py:260-276)."""
    if group is not None:
        if group.rank == 0:
            logfolder = _make_logfolder(cfg, log)
        barrier(group)
        if group.rank != 0:
            logfolder = _make_logfolder(dataclasses.replace(cfg, overwrt=False), log)
        return logfolder
    from datetime import datetime
    from zoneinfo import ZoneInfo

    date = datetime.now(ZoneInfo("Asia/Ho_Chi_Minh")).strftime("%Y-%m-%d")
    logfolder = f"{cfg.basedir}/{date}/{cfg.expname}"
    if cfg.resume and not os.path.exists(logfolder):
        prior = sorted((p for p in glob.glob(f"{cfg.basedir}/*/{cfg.expname}")
                        if os.path.isdir(p)), key=os.path.getmtime)
        if prior:
            logfolder = prior[-1]
            log(f"[resume] continuing in prior logfolder {logfolder}")
    if cfg.overwrt and not cfg.resume and os.path.exists(logfolder):
        shutil.rmtree(logfolder)
    os.makedirs(logfolder, exist_ok=True)
    for sub in ("imgs_vis", "imgs_rgba", "rgba"):
        os.makedirs(f"{logfolder}/{sub}", exist_ok=True)
    return logfolder


def _latest_ckpt(logfolder: str) -> Optional[Tuple[str, int]]:
    """The newest (by mtime) ``.npz`` checkpoint in the logfolder that
    carries a resume position, as (path, iteration); None without one."""
    for path in sorted(glob.glob(f"{logfolder}/*.npz"), key=os.path.getmtime, reverse=True):
        if os.path.basename(path) == "history.npz":
            continue
        try:
            data = np.load(path, allow_pickle=False)
            extra = json.loads(bytes(data["kwargs"]).decode()).get("extra") or {}
        except (OSError, ValueError, KeyError):  # a partial or foreign file
            continue
        if "iteration" in extra:
            return path, int(extra["iteration"])
    return None


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def _summary_writer(logfolder: str):
    """A tensorboardX SummaryWriter on the logfolder, or a writer that
    drops everything when tensorboardX does not import."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(logfolder)


def _gift_dataset(cfg: TrainConfig, scene, split: str):
    """The single view of the progress figures (reference train.py:176-177,
    frame 26); None when the split has no such frame."""
    try:
        return _dataset(cfg, scene, split, num_images=[26], is_stack=True)
    except (IndexError, OSError):
        return None


def _save(state: TrainState, path: str, iteration: int, history: Dict[str, list],
          window: Dict[str, list]) -> str:
    """A resumable checkpoint at ``iteration``: the field, aabb and mask,
    the schedule position and budgets in ``extra``, the optimizer's
    ``opt/`` leaves, and in ``aux`` the sampler's state (under
    ``port_sampler``: the JAX loop reads its own ``sampler`` key only, and
    restratifies without it), the history rows and ``window``, the train
    PSNR window and the last test PSNRs the next history row averages."""
    extra = dict(iteration=int(iteration), n_samples=int(state.n_samples),
                 l1_weight=float(state.l1_weight), ratio=float(state.ratio),
                 lr_scale=float(state.lr_scale), run_budget=int(state.run_budget),
                 prefilter_run=int(state.prefilter_run),
                 strata_budgets=state.strata_budgets,
                 strata_alive_budgets=state.strata_alive_budgets,
                 strata_n_samples=(None if state.strata_n_samples is None
                                   else list(state.strata_n_samples)),
                 strata_loss_w=state.strata_loss_w,
                 overflow_strikes=list(state.overflow_strikes))
    meta, arrays = state.sampler.get_state()
    kind = "stratified" if isinstance(state.sampler, StratifiedSampler) else "simple"
    extra["port_sampler"] = dict(kind=kind, **meta)
    aux = {f"port_sampler/{k}": v for k, v in arrays.items()}
    aux.update({f"history/{k}": np.asarray(v) for k, v in history.items()})
    # the progress reads behind the next history row's PSNR columns
    aux.update({f"progress/{k}": np.asarray(v, np.float64) for k, v in window.items()})
    return save_checkpoint(path, state.field, state.geometry.aabb_np, state.alpha_mask, extra,
                           opt_leaves=optimizer_to_jax(state.optimizer, state.field), aux=aux)


class ReconstructionResult(NamedTuple):
    final_path: str  # the final checkpoint
    total_loss: List[float]  # per step
    test_psnrs: Dict[int, float]  # mean test-set PSNR at each vis_every iteration
    final_psnrs: List[float]  # per test view after training (render_test=1)
    # the largest eval overflow of each test-set evaluation by iteration,
    # the one after training under n_iters (0.0: nothing under-integrated)
    eval_overflow: Dict[int, float]
    segments: List[dict]  # steps, grid, n_samples, strata, ms/step, peak GiB per segment
    events: List[dict]  # each schedule event's outcome
    # the final state; None for a launch that spawned its ranks (the fields
    # stay in the ranks' processes: the result is rank 0's otherwise)
    state: Optional[TrainState]
    plans: List[dict]  # each stratification plan and budget raise, in order
    progress: List[dict]  # each progress read: iteration, psnr, mse, overflow per budget


def reconstruction(
    cfg: TrainConfig,
    scene: Optional[Dict[str, dict]] = None,
    device=None,
    *,
    save_images: bool = True,
    log: Callable[[str], None] = print,
    on_step: Optional[Callable[[int, TrainState], None]] = None,
    group: Optional[RankGroup] = None,
) -> ReconstructionResult:
    """Run ``cfg``'s schedule (tensorf_tpu loop.py:195-1420).

    ``scene`` is an in-memory dataset (data/synthetic.py); None reads
    ``cfg.datadir``.  ``save_images`` writes the final evaluations' PNGs,
    videos and mean.txt, the progress figures and the GIF (needs imageio
    and matplotlib).  ``on_step(it, state)`` runs after step ``it``, before
    that iteration's evaluation, events and checkpoint.  Segment times
    exclude the evaluations and events between them; the first segment's
    start after the run's first step.  With ``cfg.resume`` the run
    continues from the newest resumable checkpoint in its logfolder (a
    fresh start without one); a finished run then only renders.

    ``cfg.n_devices`` (0: every visible card; on the CPU 0 is one rank)
    above one spawns that many ranks, one per card, each running this
    schedule (``log`` and ``on_step`` must then pickle, and run in the
    ranks), and returns rank 0's result without its state.
    ``cfg.distributed`` joins the ranks the environment names
    (parallel/launch.py::join_from_env).  ``group``: this process is
    already that rank of a data-parallel run (the spawned ranks, tests).
    """
    device = resolve_device(device)
    if group is None and cfg.distributed:
        group = join_from_env(cfg.n_devices, device)
        try:
            return reconstruction(cfg, scene, group.device, save_images=save_images, log=log,
                                  on_step=on_step, group=group)
        finally:
            destroy_group()
    if group is None:
        devices = rank_devices(cfg.n_devices, device)
        if len(devices) > 1:
            return spawn(_reconstruction_rank, (cfg, scene, save_images, log, on_step),
                         devices)[0]
    # armed before any device work; setup milestones and every step beat
    # it, and writes under the build directory count as progress
    watchdog = Watchdog(cfg.wedge_timeout_s, tag=cfg.expname,
                        resume_hint="python -m tensorf_tpu_torch ... --resume 1",
                        cache_dirs=[str(BUILD_DIR)]).start()
    writer = None
    profile = _ProfileWindow(cfg, device, log, group)
    try:
        logfolder = _make_logfolder(cfg, log, group)
        # rank 0 alone writes event files: every rank reads the same scalars
        writer = _summary_writer(logfolder) if is_writer(group) else _NullWriter()
        return _reconstruct(cfg, scene, device, save_images, log, on_step, watchdog, writer,
                            logfolder, group, profile)
    finally:
        profile.close()
        watchdog.stop()
        if writer is not None:
            writer.close()


class _ProfileWindow:
    """``profile_dir``: a ``torch.profiler`` trace of the ``profile_steps``
    steps from ``profile_start`` (host ops, the port's ``tftorch.*`` spans
    and, on a card, the device's activities), written to ``profile_dir`` as
    a Chrome trace, one file a rank, and a log line of the counters those
    steps recorded (utils/tracing.py), as the JAX loop brackets its steps
    with ``jax.profiler``."""

    def __init__(self, cfg: TrainConfig, device: torch.device, log: Callable[[str], None],
                 group: Optional[RankGroup]):
        self.dir, self.start = cfg.profile_dir, int(cfg.profile_start)
        self.last = self.start + max(int(cfg.profile_steps), 1) - 1
        self.device, self.log, self.group = device, log, group
        self.prof = None

    def before_step(self, iteration: int) -> None:
        if not self.dir or iteration != self.start or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        tracing.take_counts()  # what another profiler left
        self.prof = profile(activities=activities)
        self.prof.start()

    def after_step(self, iteration: int) -> None:
        if self.prof is not None and iteration >= self.last:
            self.close()

    def close(self) -> None:
        """Stop and write the trace, if one runs (the run may end first)."""
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        _sync(self.device)
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        rank = f"_rank{self.group.rank}" if self.group is not None else ""
        path = os.path.join(self.dir, f"trace_{self.start}-{self.last}{rank}.json")
        prof.export_chrome_trace(path)
        self.log(f"[profile] trace written to {path}")
        counts = tracing.take_counts()

        def pct(num: str, den: str) -> str:
            return f"{100.0 * counts[num] / counts[den]:.3f}%" if counts.get(den) else "n/a"

        calls = counts.get("scatter_add", [])
        self.log(f"[profile] density slot use {pct('render.alive', 'render.density_rows')}, "
                 f"shade slot use {pct('render.shaded', 'render.shade_rows')}, scatter_add "
                 f"{len(calls)} calls, {sum(c[0] for c in calls)} rows")


def _reconstruction_rank(group: RankGroup, device, cfg, scene, save_images, log, on_step):
    """One spawned rank of an ``n_devices`` launch."""
    return reconstruction(cfg, scene, device, save_images=save_images, log=log, on_step=on_step,
                          group=group)._replace(state=None)


def _agreed_ckpt(found, group: Optional[RankGroup], log):
    """The newest checkpoint when every rank found the same iteration's;
    None (a fresh start on every rank) when they disagree, as the JAX loop
    decides (tensorf_tpu loop.py:299-316)."""
    if group is None:
        return found
    it = np.asarray([found[1] if found else -1], np.int64)
    hi, lo = int(host_allmax(it, group)[0]), -int(host_allmax(-it, group)[0])
    if hi != lo or lo < 0:
        if found:
            log(f"[resume] ranks disagree on the newest iteration ({lo} vs {hi}) — fresh start "
                f"on every rank")
        return None
    return found


def _reconstruct(cfg, scene, device, save_images, log, on_step, watchdog, writer, logfolder,
                 group, profile):
    """``reconstruction``'s body, inside its watchdog, summary writer and
    profile window."""
    writes = is_writer(group)
    # the figures and images are rank 0's
    save_images = save_images and writes
    if cfg.resume and not cfg.ckpt_path:
        found = _agreed_ckpt(_latest_ckpt(logfolder), group, log)
        if found:
            cfg = dataclasses.replace(cfg, ckpt_path=found[0])
            log(f"[resume] newest checkpoint: {found[0]}")
        else:
            log(f"[resume] no checkpoint under {logfolder} — fresh start")
    state = TrainState(cfg, device, scene, group)
    resume_extra, start_iter = state.resume_extra, state.start_iter
    history = defaultdict(list)
    psnrs_window, psnrs_test = [], [0.0]
    if resume_extra is not None:
        log(f"[resume] continuing at iteration {start_iter} (n_samples {state.n_samples}, "
            f"lr_scale {state.lr_scale:g})")
        state.restore_optimizer(load_opt_leaves(cfg.ckpt_path), log)
        aux = load_aux(cfg.ckpt_path)
        # the history rows written before the interruption, and the progress
        # reads their next row averages
        for k, v in aux.items():
            if k.startswith("history/"):
                history[k[len("history/"):]] = list(np.asarray(v))
        psnrs_window = [float(v) for v in aux.get("progress/psnrs_window", [])]
        psnrs_test = [float(v) for v in aux.get("progress/psnrs_test", [0.0])]
    # the field replicated from rank 0, as the JAX loop replicates it
    state.broadcast()
    watchdog.beat()  # setup milestone: datasets, field and ray store on the device
    train_gift = test_gift = None
    if save_images:
        train_gift = _gift_dataset(cfg, scene, "train")
        test_gift = _gift_dataset(cfg, scene, "test")
    log(f"[port] {cfg.model_name} grid {state.geometry.grid_size} n_samples "
        f"{state.n_samples} batch {cfg.batch_size} store {state.rays.shape[0]} rays "
        f"on {device}; logfolder {logfolder}"
        + (f"; rank {group.rank} of {group.world} ({group.backend}, "
           f"{'own id pool' if group.pooled else 'blocks of the global batch'})"
           if group else ""))

    event_iters = set(cfg.update_AlphaMask_list) | set(cfg.upsamp_list)
    # reseeded every step from (seed, iteration): stateless noise
    noise = torch.Generator(device=device)
    totals, segments, events, test_psnrs, plans, progress = [], [], [], {}, [], []
    eval_overflow = {}

    def stratify(iteration: int) -> None:
        plan = restratify(state, iteration, log)
        if plan is not None:
            plans.append(plan)

    step_fn = None
    if start_iter < cfg.n_iters:
        # partition the store up front (by in-bbox chord before the first
        # mask), or restore the plan and sampler the checkpoint carries
        if resume_extra is None or not state.restore_sampling_state(resume_extra, aux, log):
            stratify(start_iter)
        step_fn = make_train_step(state.field, build_statics(state), state.optimizer, group)
    # else: a finished run's resume goes straight to the final renders,
    # with no count pass and no step built
    aabb = state.aabb
    seg = None
    run_tic = time.perf_counter()

    def open_segment(start: int) -> dict:
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        return dict(start=start, grid=tuple(state.geometry.grid_size),
                    n_samples=state.n_samples, store=int(state.rays.shape[0]),
                    masked=state.alpha_mask is not None, **_sampling_summary(state),
                    t0=time.perf_counter(), paused=0.0)

    def close_segment(seg: dict, end: int) -> None:
        _sync(device)
        seg["end"] = end
        seg["ms_per_step"] = (time.perf_counter() - seg.pop("t0") - seg.pop("paused")) * 1e3 / (
            end - seg["start"] + 1)
        seg["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                           if device.type == "cuda" else math.nan)
        segments.append(seg)
        log(f"[port] segment {seg['start']}..{end}: grid {seg['grid']} n_samples "
            f"{seg['n_samples']} {seg['ms_per_step']:.3f} ms/step peak {seg['peak_gib']:.2f} GiB")

    watchdog.resume_hint = f"python -m tensorf_tpu_torch ... --resume 1 (logfolder {logfolder})"
    for iteration in range(start_iter, cfg.n_iters):
        watchdog.beat()
        profile.before_step(iteration)
        noise.manual_seed(step_seed(cfg.seed, iteration))
        metrics = step_fn(aabb, state.rays, state.rgbs, iteration, noise, state.alpha_mask,
                          ids=state.next_ids())
        totals.append(metrics["total_loss"])
        if seg is None and iteration == start_iter:
            seg = open_segment(iteration + 1)
        if on_step is not None:
            on_step(iteration, state)
        if iteration % max(int(cfg.progress_refresh_rate), 1) == 0:
            # the only host read of the metrics: at the progress rate
            with tracing.span("tftorch.train.progress"):
                if state.strata_budgets is not None:
                    per_budget = metrics["stratum_overflow"].tolist()
                else:
                    per_budget = [float(metrics["budget_overflow_frac"])]
                progress.append(dict(iteration=iteration, psnr=float(metrics["psnr"]),
                                     mse=float(metrics["mse"]), overflow=per_budget))
            psnrs_window.append(progress[-1]["psnr"])
            _write_scalars(writer, metrics, progress[-1], iteration)
            log(f"Iteration {iteration:05d}: train_psnr = {np.mean(psnrs_window):.2f} "
                f"test_psnr = {np.mean(psnrs_test):.2f} mse = {progress[-1]['mse']:.6f} overflow "
                f"{[round(o, 4) for o in per_budget]} "
                f"elapsed = {time.perf_counter() - run_tic:.1f}s")
            psnrs_window = psnrs_window[-50:]
            raised = raise_budgets(state, per_budget, iteration, log)
            if raised:
                plans.append(dict(event="budget_raise", iteration=iteration, raised=raised))
                step_fn = make_train_step(state.field, build_statics(state), state.optimizer,
                                          group)
        profile.after_step(iteration)
        boundary = iteration in event_iters or iteration == cfg.n_iters - 1
        if boundary and seg is not None and iteration >= seg["start"]:
            close_segment(seg, iteration)
            seg = None

        # test PSNR (vis_every) and the progress row and figure
        # (train_vis_every) are independent, as in the JAX loop
        do_test_eval = cfg.vis_every > 0 and iteration % cfg.vis_every == 0 and iteration > 0
        do_train_vis = (cfg.train_vis_every > 0 and iteration % cfg.train_vis_every == 0
                        and iteration > 0)
        if do_test_eval or do_train_vis:
            _sync(device)
            t0 = time.perf_counter()
            handle = make_handle(state)
            if do_test_eval:
                psnrs_test = psnrs_calculate(handle, state.test_ds, chunk=cfg.batch_size,
                                             heartbeat=watchdog.beat) or [0.0]
                test_psnrs[iteration] = float(np.mean(psnrs_test))
                eval_overflow[iteration] = handle.max_overflow
                writer.add_scalar("test/psnr", test_psnrs[iteration], iteration)
                log(f"[{iteration}] test psnr {test_psnrs[iteration]:.4f}")
            if do_train_vis:
                history["iteration"].append(iteration)
                history["train_psnr"].append(round(float(np.mean(psnrs_window or [0])), 2))
                history["test_psnr"].append(round(float(np.mean(psnrs_test)), 2))
                history["mse"].append(round(float(metrics["mse"]), 5))
                if train_gift is not None:
                    # rank 0 alone renders the figure: on one rank
                    save_rendered_image_per_train(train_gift, test_gift,
                                                  dataclasses.replace(handle, group=None),
                                                  iteration,
                                                  history, savePath=f"{logfolder}/gif/",
                                                  chunk=cfg.batch_size)
            if seg is not None:
                seg["paused"] += time.perf_counter() - t0

        if iteration in event_iters:
            step_fn = None  # holds the optimizer, whose state the events drop
            if iteration in cfg.update_AlphaMask_list:
                events.append(alpha_mask_event(state, iteration))
                log(f"[{iteration}] {events[-1]}")
            if iteration in cfg.upsamp_list:
                events.append(upsample_event(state, iteration))
                log(f"[{iteration}] {events[-1]}")
            # rank 0's rebuilt factors and mask on every rank (tensorf_tpu
            # loop.py:1345-1347)
            state.broadcast()
            # every event moves the per-ray counts: re-partition the store
            stratify(iteration)
            step_fn = make_train_step(state.field, build_statics(state), state.optimizer, group)
            aabb = state.aabb
            if iteration < cfg.n_iters - 1:
                seg = open_segment(iteration + 1)

        if iteration in (cfg.save_ckpt_every or []) and writes:
            _save(state, f"{logfolder}/{iteration // 1000}k_{cfg.expname}.npz", iteration,
                  history, dict(psnrs_window=psnrs_window, psnrs_test=psnrs_test))

    profile.close()
    # the final renders are device work too: the watchdog stays armed,
    # beaten per rendered image
    watchdog.beat()
    # resumable too: a resume of the finished run goes straight to the renders
    final_path = f"{logfolder}/final_{cfg.expname}.npz"
    if writes:
        _save(state, final_path, cfg.n_iters - 1, history,
              dict(psnrs_window=psnrs_window, psnrs_test=psnrs_test))
    watchdog.beat()
    elapsed = time.perf_counter() - run_tic
    if writes:
        np.savetxt(f"{logfolder}/training_time.txt", np.asarray([elapsed]))
    log(f"Total time {elapsed:.2f}s.")
    handle = make_handle(state)
    final_psnrs = _render_after_training(cfg, scene, handle, state.test_ds, logfolder,
                                         save_images, log, heartbeat=watchdog.beat)
    if final_psnrs:
        writer.add_scalar("test/psnr_all", float(np.mean(final_psnrs)), cfg.n_iters)
    eval_overflow[cfg.n_iters] = handle.max_overflow
    watchdog.stop()
    if group is not None:
        # equal on every rank: the ranks hold the same parameters bit for bit
        log(f"[port] rank {group.rank} of {group.world}: parameter digest "
            f"{param_digest(state.field)!r}")
    if writes:
        np.savez(f"{logfolder}/history.npz", **{k: np.asarray(v) for k, v in history.items()})
    # the ranks leave together: a rank's files are written when any returns
    barrier(group)
    if save_images:
        create_gif(f"{logfolder}/gif/plot/vis_every", f"{logfolder}/gif/training.gif")
    totals = torch.stack(totals).tolist() if totals else []
    return ReconstructionResult(final_path, totals, test_psnrs, final_psnrs, eval_overflow,
                                segments, events, state, plans, progress)


def _write_scalars(writer, metrics: Dict[str, torch.Tensor], read: dict, iteration: int) -> None:
    """The train scalars of a progress read (tensorf_tpu loop.py:1036-1047);
    nothing more is read from the device when no writer records them."""
    if isinstance(writer, _NullWriter):
        return
    writer.add_scalar("train/PSNR", read["psnr"], iteration)
    writer.add_scalar("train/mse", read["mse"], iteration)
    for k in ("reg_ortho", "reg_l1", "reg_tv_density", "reg_tv_app", "reg_occ"):
        if k in metrics:
            writer.add_scalar(f"train/{k}", float(metrics[k]), iteration)
    writer.add_scalar("train/mean_alive_samples",
                      float(metrics.get("mean_alive_samples", 0.0)), iteration)
    writer.add_scalar("train/budget_overflow_frac",
                      float(metrics.get("budget_overflow_frac", 0.0)), iteration)


def _sampling_summary(state: TrainState) -> dict:
    """How the current segment samples: strata (0 = unstratified), their
    budgets, lattices and quotas, and the density samples a step queries."""
    statics = build_statics(state)
    quotas = state.quotas or [state.cfg.batch_size]
    return dict(
        strata=0 if state.strata_budgets is None else len(state.strata_budgets),
        budgets=list(statics.strata_budgets or [statics.sample_budget]),
        lattices=list(statics.strata_n_samples or [state.n_samples] * len(quotas)),
        quotas=list(quotas),
        samples_per_step=int(sum(q * n for q, n in zip(quotas, render_widths(statics)))),
    )


def render_test(
    cfg: TrainConfig,
    scene: Optional[Dict[str, dict]] = None,
    device=None,
    *,
    save_images: bool = True,
    log: Callable[[str], None] = print,
) -> List[float]:
    """Render-only entry (reference train.py:77-165): load ``cfg.ckpt`` (or
    ``ckpt_path``), render what ``render_train``, ``render_test`` and
    ``render_path`` ask for and return the test split's per-view PSNRs;
    with ``save_images`` the images go beside the checkpoint.  As in the JAX
    entry, the whole test split renders (no few-shot selection) and the
    train split loads only for ``render_train``."""
    device = resolve_device(device)
    ckpt = cfg.ckpt or cfg.ckpt_path
    if not ckpt or not os.path.exists(ckpt):
        log("the ckpt path does not exists!!")
        return []
    model_cfg, field, aabb, grid_size, alpha_mask, _ = load_checkpoint(ckpt, device)
    geometry = GridGeometry.create(aabb, grid_size, model_cfg.step_ratio)
    test_ds = _dataset(cfg, scene, "test", is_stack=True)
    handle = RendererHandle(
        field=field,
        alpha_mask=alpha_mask,
        aabb=torch.as_tensor(geometry.aabb_np, device=device),
        step_size=geometry.step_size,
        n_samples=min(int(cfg.nSamples), geometry.n_samples),
        white_bg=test_ds.white_bg,
        ndc_ray=bool(cfg.ndc_ray),
        shade_top_k=cfg.shade_top_k if cfg.shade_top_k > 0 else None,
        fused=bool(cfg.fused_gathers),
        # the configured budget, as the JAX render-only entry takes it
        sample_budget=cfg.sample_budget if alpha_mask is not None and cfg.sample_budget > 0 else None,
        use_coarse_gate=coarse_gate_valid(alpha_mask, geometry.step_size, bool(cfg.ndc_ray)),
        stratified=bool(cfg.stratify_render) and not cfg.ndc_ray,
    )
    return _render_after_training(cfg, scene, handle, test_ds, os.path.dirname(ckpt),
                                  save_images, log)


class MeshExport(NamedTuple):
    ply: str  # the .ply written beside the checkpoint
    mesh: PlyMesh  # its vertices (world space) and triangles
    native: bool  # the native marching library ran (else the numpy version)
    alpha_ms: float  # compute_alpha_grid, host clock, device synchronised at both ends
    march_ms: float  # the iso-surface extraction and the .ply write, on the host


def export_mesh(cfg: TrainConfig, ckpt_path: Optional[str] = None, device=None,
                log: Callable[[str], None] = print) -> MeshExport:
    """Mesh-export entry (tensorf_tpu loop.py:1490-1507, reference
    train.py:59-74): load ``ckpt_path`` (else ``cfg.ckpt``, else
    ``cfg.ckpt_path``) on ``device`` (cuda unless asked), compute its dense
    alpha grid there, and write the level-0.005 iso-surface to the
    checkpoint's path with ``.ply`` in place of its extension."""
    device = resolve_device(device)
    ckpt = ckpt_path or cfg.ckpt or cfg.ckpt_path
    model_cfg, field, aabb, grid_size, alpha_mask, _ = load_checkpoint(ckpt, device)
    geometry = GridGeometry.create(aabb, grid_size, model_cfg.step_ratio)
    _sync(device)
    t0 = time.perf_counter()
    alpha, _ = compute_alpha_grid(field, alpha_mask, geometry.aabb_np, geometry.grid_size,
                                  geometry.step_size)
    alpha = alpha.cpu().numpy()
    alpha_ms = (time.perf_counter() - t0) * 1e3
    native = native_available()
    out = ckpt.rsplit(".", 1)[0] + ".ply"
    t0 = time.perf_counter()
    mesh = convert_alpha_samples_to_ply(alpha, out, geometry.aabb_np, level=0.005)
    march_ms = (time.perf_counter() - t0) * 1e3
    log(f"[mesh] {out}: grid {geometry.grid_size}, {len(mesh.verts)} verts, "
        f"{len(mesh.tris)} faces, {'native' if native else 'numpy'} marching; alpha grid "
        f"{alpha_ms:.1f} ms, marching {march_ms:.1f} ms")
    return MeshExport(out, mesh, native, alpha_ms, march_ms)


class TrainResult(NamedTuple):
    total_loss: List[float]  # per step
    step_ms: float  # mean ms/step over steps 2..n (host clock, device synced at both ends)
    test_psnr: float
    test_rgb: np.ndarray  # (H, W, 3) rendered test view
    n_samples: int
    grid_size: Tuple[int, int, int]
    field: torch.nn.Module  # the trained field


def train_steps(
    cfg: TrainConfig,
    n_steps: int,
    *,
    device=None,
    scene: Optional[Dict[str, dict]] = None,
    chunk: int = 4096,
    log: Callable[[str], None] = print,
    on_step: Optional[Callable[[int, TrainState], None]] = None,
) -> TrainResult:
    """Train ``n_steps`` steps of the first segment, then render test view 0.

    ``scene`` is an in-memory dataset ({split: transforms dict with inline
    images}, see data/synthetic.py::make_synthetic_scene_arrays); None reads
    ``cfg.datadir`` from disk.  With ``cfg.ckpt_path`` set the steps start
    from that checkpoint's field, grid and mask.  The store is stratified
    once, before the first step; budgets are not auto-raised here.
    ``on_step(it, state)`` runs after each step is enqueued (profile_step.py
    brackets steps with it).
    """
    device = resolve_device(device)
    if cfg.distributed or len(rank_devices(cfg.n_devices, device)) > 1:
        raise ValueError("train_steps runs on one device: set n_devices 1 and distributed 0, or "
                         "use reconstruction")
    end = first_segment_end(cfg)
    if n_steps > end:
        raise ValueError(
            f"train_steps runs the first schedule segment only: n_steps={n_steps} "
            f"passes the first schedule event at iteration {end}; use reconstruction"
        )
    state = TrainState(cfg, device, scene)
    log(
        f"[port] {cfg.model_name} grid {state.geometry.grid_size} n_samples {state.n_samples} "
        f"batch {cfg.batch_size} store {state.rays.shape[0]} rays on {device}"
    )
    restratify(state, 0, log)
    step_fn = make_train_step(state.field, build_statics(state), state.optimizer)
    noise = torch.Generator(device=device)
    aabb = state.aabb
    totals = []
    t_first = None
    for it in range(n_steps):
        noise.manual_seed(step_seed(cfg.seed, it))
        metrics = step_fn(aabb, state.rays, state.rgbs, it, noise, state.alpha_mask,
                          ids=state.next_ids())
        totals.append(metrics["total_loss"])
        if it == 0:
            _sync(device)
            t_first = time.perf_counter()
        if on_step is not None:
            on_step(it, state)
    _sync(device)
    step_ms = (
        (time.perf_counter() - t_first) * 1e3 / (n_steps - 1) if n_steps > 1 else math.nan
    )
    totals = torch.stack(totals).tolist() if totals else []
    for it in range(0, n_steps, max(int(cfg.progress_refresh_rate), 1)):
        log(f"[port] iter {it}: loss {totals[it]:.6f}")

    W, H = state.test_ds.img_wh
    handle = make_handle(state)
    rgb, _, _ = handle.render(state.test_ds.all_rays[0], chunk=chunk)
    rgb = rgb.reshape(H, W, 3)
    gt = np.asarray(state.test_ds.all_rgbs[0], np.float32)
    test_psnr = float(-10.0 * np.log10(np.mean((rgb - gt) ** 2)))
    log(f"[port] test view 0 psnr {test_psnr:.4f}")
    return TrainResult(
        total_loss=totals,
        step_ms=step_ms,
        test_psnr=test_psnr,
        test_rgb=rgb,
        n_samples=state.n_samples,
        grid_size=tuple(state.geometry.grid_size),
        field=state.field,
    )
