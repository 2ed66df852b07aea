"""Rank functions that hold the data-parallel paths against one rank.

The tests and chip_smoke.py run them on several ranks with
``launch.spawn`` (which re-imports this module in every rank, so it
imports torch and the port only) and in-process with ``group=None`` for
the one-rank reference:

- ``one_step``: one train step of a field on a rank's block of a global
  batch, optionally with given noise and a given Adam state
  (``adam_in_progress``);
- ``serve``: one frame through the eval's ``RendererHandle``, its chunks
  split over the ranks;
- ``reconstruct``: ``reconstruction`` on a rank, with what a check of the
  ranks' agreement needs (plan lines, parameter checksums after every
  event, the kernel's launches, the statics each step ran under and the
  rows each of its renders ran the density on and shaded,
  ``recording_renders``);
- ``agreed_resume`` and ``fail_on_rank``: the resume agreement and a
  failing rank, for the launch's tests.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from .mesh import RankGroup, param_digest


def adam_in_progress(field: torch.nn.Module, second_moment: float = 1e-6) -> list:
    """The JAX layout's optimizer leaves (convert.py) of an Adam state one
    step in: counts 1, first moments 0, second moments ``second_moment``.
    From it a step's update is a smooth function of the gradient, unlike a
    first Adam step (about lr * sign(g), which float summation order flips
    on gradients near zero): so ranks and packages compare parameters."""
    from ..convert import _opt_layout, optimizer_to_jax
    from ..train.optim import make_optimizer

    leaves = optimizer_to_jax(make_optimizer(field), field)
    out, pos = [], 0
    for _, params in _opt_layout(field):
        k = len(params)
        out.append(np.int32(1))
        out += [np.zeros_like(a) for a in leaves[pos + 1: pos + 1 + k]]
        out += [np.full_like(a, second_moment) for a in leaves[pos + 1 + k: pos + 1 + 2 * k]]
        out.append(np.int32(1))
        pos += 2 + 2 * k
    return out


def _field(case: dict, device):
    from ..models.tensorf import FIELD_MODELS

    field = FIELD_MODELS[case["model_cfg"].model_name](case["model_cfg"], tuple(case["grid"]),
                                                       device)
    field.load_state_dict({k: torch.as_tensor(v) for k, v in case["params"].items()})
    return field


def _mask(case: dict, device):
    from ..models.alpha_mask import AlphaGridMask, with_dilation

    if case.get("mask") is None:
        return None
    aabb, volume = case["mask"]
    return with_dilation(AlphaGridMask(aabb=torch.as_tensor(aabb, device=device),
                                       volume=torch.as_tensor(volume, device=device)))


def one_step(group: Optional[RankGroup], device, case: dict) -> dict:
    """One ``make_train_step`` step on this rank.  ``case``: ``model_cfg``
    (the port's ModelConfig), ``grid``, ``params`` (a numpy state dict),
    ``aabb``, ``mask`` (None or (aabb, volume)), ``statics``, ``lr`` (lr_init,
    lr_basis, lr_factor), ``opt_leaves`` (None or the JAX layout's optimizer
    leaves: an Adam state to step from), ``rays`` and ``rgbs`` (the store),
    ``ids`` (the GLOBAL batch's ids: one array, or one per stratum),
    ``step`` and either ``noise`` (the global batch's draws as numpy:
    (u, flip) or (u per stratum, flip per stratum, shares or None)) or
    ``seed`` (the noise generator's).  Returns the parameters after Adam
    (numpy), the metrics, the scatter-add's launches with the rows of each,
    and the line lerp's launches."""
    from ..convert import optimizer_from_jax
    from ..ops import grid_sample
    from ..ops.line_lerp import line_lerp
    from ..ops.scatter_add import scatter_add
    from ..train.optim import make_optimizer
    from ..train.step import make_train_step
    from .mesh import shard_rows

    device = torch.device(device)
    field = _field(case, device)
    optimizer = make_optimizer(field, *case["lr"])
    if case.get("opt_leaves") is not None:
        optimizer_from_jax(optimizer, field, case["opt_leaves"])
    statics = case["statics"]
    step_fn = make_train_step(field, statics, optimizer, group)
    rank, world = (group.rank, group.world) if group is not None else (0, 1)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    ids = case["ids"]
    if statics.strata_budgets is not None:
        ids = tuple(shard_rows(dev(i).long(), rank, world) for i in ids)
    else:
        ids = shard_rows(dev(ids).long(), rank, world)
    noise, generator = None, None
    if case.get("noise") is not None:
        if statics.strata_budgets is not None:
            u, flip, shares = case["noise"]
            noise = (tuple(dev(x) for x in u), tuple(dev(f) for f in flip),
                     None if shares is None else dev(shares))
        else:
            u, flip = case["noise"]
            noise = (dev(u), dev(flip))
    else:
        generator = torch.Generator(device=device).manual_seed(int(case["seed"]))
    rows = []
    real = grid_sample.scatter_add

    def recording(idx, g, n_rows):
        rows.append(int(g.shape[0]))
        return real(idx, g, n_rows)

    grid_sample.scatter_add = recording
    scatter_add.launches = line_lerp.launches = 0
    try:
        metrics = step_fn(dev(case["aabb"]), dev(case["rays"]),
                          dev(case["rgbs"]), int(case["step"]), generator, _mask(case, device),
                          ids=ids, noise=noise)
    finally:
        grid_sample.scatter_add = real
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(
        params={k: v.detach().cpu().numpy() for k, v in field.state_dict().items()},
        metrics={k: v.detach().cpu().numpy().tolist() for k, v in metrics.items()},
        # the largest storage behind a metric: a kept metric must not hold
        # the step's gradient buffer
        metric_bytes=max(v.untyped_storage().nbytes() for v in metrics.values()),
        launches=int(scatter_add.launches),
        rows=rows,
        line_lerp_launches=int(line_lerp.launches),
        checksum=param_digest(field),
    )


def serve(group: Optional[RankGroup], device, case: dict) -> dict:
    """One frame of ``case["rays"]`` through a ``RendererHandle`` of the
    case's field and mask (``stratified`` or uniform at ``sample_budget``),
    its chunks split over the ranks; numpy rgb and depth, the shaded
    samples and the handle's largest overflow."""
    from ..eval.evaluation import RendererHandle

    device = torch.device(device)
    handle = RendererHandle(
        field=_field(case, device), alpha_mask=_mask(case, device),
        aabb=torch.as_tensor(np.asarray(case["aabb"]), device=device),
        group=group, **case["handle"])
    with torch.no_grad():
        rgb, depth, n_valid = handle.render(case["rays"], chunk=int(case["chunk"]))
    return dict(rgb=rgb, depth=depth, n_valid=int(n_valid), overflow=handle.max_overflow)


@contextlib.contextmanager
def recording_renders():
    """A list that receives, render by render, each train-step render's
    ``(density rows, shaded samples)``: train/step.py's render_rays
    wrapped.  The density rows are its ``density_rows`` (the slots the
    density ran on: the admitted ones where the mask gates a whole lattice,
    else rays x width); the shaded samples are its ``num_valid_samples``,
    kept on the device until read.  A render without a top-K below its
    width gathers appearance for just those samples, so the kernels a step
    launches depend on both."""
    from unittest import mock

    from ..train import step

    renders = []
    inner = step.render_rays

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        renders.append((int(out.density_rows), out.num_valid_samples.detach()))
        return out

    with mock.patch.object(step, "render_rays", recording):
        yield renders


def reconstruct(group: Optional[RankGroup], device, cfg, scene, pooled: bool = False) -> dict:
    """``reconstruction`` of ``cfg`` on this rank with the kernels' launch
    counts set to 0 just before and read just after.  Records the log lines,
    a parameter checksum after each event (read at the next step, after the
    broadcast and that step's all-reduce) and at the end, and the statics
    of every step with this rank's share of each sub-batch (from which the
    caller computes the launches the steps call for).  ``pooled``: the
    ranks draw as a distributed run's do, each from its own id pool."""
    if pooled:
        group = group._replace(pooled=True)
    from ..ops.line_lerp import line_lerp
    from ..ops.scatter_add import scatter_add, scatter_add_bf16
    from ..train.loop import build_statics, reconstruction

    lines = []
    checksums: Dict[int, float] = {}
    # [statics, local batches, grid, line dtype, grid dtype,
    #  (density rows, shaded) a render, n_steps]
    steps = []
    event_iters = set(cfg.update_AlphaMask_list) | set(cfg.upsamp_list)
    world = group.world if group is not None else 1

    def on_step(it, state):
        # every rank renders 1/W of each global quota
        batches = [q // world for q in (state.quotas or [cfg.batch_size])]
        sig = [build_statics(state), batches, tuple(state.geometry.grid_size),
               state.field.line_a_dtype, state.field.grid_dtype,
               list(zip([rows for rows, _ in renders],
                        torch.stack([n for _, n in renders]).tolist())) if renders else []]
        renders.clear()
        if steps and steps[-1][:-1] == sig:
            steps[-1][-1] += 1
        else:
            steps.append(sig + [1])
        if it - 1 in event_iters or it == cfg.n_iters - 1:
            checksums[it] = param_digest(state.field)

    scatter_add.launches = scatter_add_bf16.launches = line_lerp.launches = 0
    with recording_renders() as renders:
        result = reconstruction(cfg, scene, device, save_images=False, log=lines.append,
                                on_step=on_step, group=group)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return dict(
        launches={"scatter_add": int(scatter_add.launches),
                  "scatter_add_bf16": int(scatter_add_bf16.launches),
                  "line_lerp": int(line_lerp.launches)},
        lines=lines, checksums=checksums, steps=steps,
        final_checksum=param_digest(result.state.field),
        result=result._replace(state=None),
        grid=tuple(result.state.geometry.grid_size),
        quotas=result.state.quotas,
    )


def agreed_resume(group: RankGroup, device, cases) -> list:
    """For each case, the checkpoint every rank resumes from when rank r
    found ``case[r]`` ((path, iteration) or None)."""
    from ..train.loop import _agreed_ckpt

    return [_agreed_ckpt(found[group.rank], group, print) for found in cases]


def fail_on_rank(group: RankGroup, device, bad_rank: int, how: str) -> int:
    """Rank ``bad_rank`` raises (``how`` "raise") or exits with the
    watchdog's code ("wedge"); the others wait at a barrier it never
    reaches."""
    import os

    from ..utils.watchdog import EXIT_WEDGED
    from .mesh import barrier

    if group.rank == bad_rank:
        if how == "wedge":
            os._exit(EXIT_WEDGED)
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    barrier(group)
    return group.rank
