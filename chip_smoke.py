#!/usr/bin/env python3
"""Drive tensorf_tpu_torch's main path on one NVIDIA GPU and hold every
CUDA kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero, no phase is caught and passed over):
  1. build every kernel of the path from the checkout's sources with nvcc
     (sm_90a), all at once;
  2. kernel phase: each kernel against its plain version on the card, at the
     shapes the main path gives it plus edge cases, with its times;
  3. step parity: one synth_full train step with the kernels and one with
     the plain versions, same params, batch and jitter; gradients must agree;
  4. main path: the trainer of configs/synth_full.txt at full width (128^3
     segment, batch 4096, 443 samples, ranks 16/48, MLP_Fea 128; with
     stratification and sample budgets off, as they are not ported yet) for
     a few steps on an in-memory composite scene, then one test view rendered in
     chunks; the loss must fall and each kernel must have launched;
  5. the rendered view against the CPU reference path on a few rays;
  6. the kernel against its plain version on the real index streams: the
     (idx, g) that one more train step of the trained field hands to the
     first density and the first appearance scatter-add.
Each kernel case also prints its index stream's mean run length and mean
distinct rows per 64-row tile: what the kernel's run aggregation exploits.

The scene is cut to size for the time limit (each cut is printed): 8 train
and 2 test views instead of 40 and 8, 200x200 pixels instead of 800x800,
and 200 steps of the 30000-step schedule (its first segment only).

Without a GPU, or outside a checkout of the repo, it exits non-zero and
prints no result.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# A fresh synth_full field's loss sits on a plateau for its first ~140
# steps at 128^3 (density starts near zero under density_shift -10 and the
# FreeNeRF masks open slowly), then falls steeply: 200 steps show the fall.
TRAIN_STEPS = 200
SCENE = dict(n_train=8, n_test=2, wh=(200, 200), scene="composite")
LAUNCHES_PER_STEP = {"scatter_add": 6}  # 3 density + 3 appearance planes
MAIN_SHAPES = ("density_128", "appearance_128", "density_300", "appearance_300",
               "density_128_real", "appearance_128_real")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lattice_plane_indices(torch, rays, n_samples, grid, dev):
    """The footprint-gather row indices of density plane 0 for these rays:
    the index stream the main path's first scatter-add receives."""
    from tensorf_tpu_torch.models.config import GridGeometry
    from tensorf_tpu_torch.ops.rays import sample_along_rays
    from tensorf_tpu_torch.render.volume import normalize_coord

    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3], device=dev)
    step = GridGeometry.create(aabb.cpu().numpy(), grid, 0.5).step_size
    xyz, _, _ = sample_along_rays(rays[:, :3], rays[:, 3:6], aabb, 2.0, 6.0, step, n_samples, None)
    c = torch.clamp(normalize_coord(xyz, aabb).reshape(-1, 3)[:, [0, 1]], -1.0, 1.0)
    H, W = grid[1], grid[0]
    x = torch.floor((c[:, 0] + 1.0) * 0.5 * (W - 1)).to(torch.int32)
    y = torch.floor((c[:, 1] + 1.0) * 0.5 * (H - 1)).to(torch.int32)
    return (y * W + x).contiguous()


def stream_stats(torch, idx, tile=64):
    """What the kernel's run aggregation can exploit in an index stream: the
    mean length of runs of equal consecutive indices, and the mean number of
    distinct rows in a ``tile``-row tile (a tile with fewer distinct rows
    than runs would gain from sorting it)."""
    M = idx.shape[0]
    runs = 1 + int((idx[1:] != idx[:-1]).sum())
    n_tiles = max(1, M // tile)
    t = torch.sort(idx[: n_tiles * tile].reshape(n_tiles, -1), dim=1).values
    distinct = 1 + (t[:, 1:] != t[:, :-1]).sum(dim=1)
    return M / runs, float(distinct.float().mean())


def kernel_case(torch, name, idx, g, n_rows):
    """scatter_add against scatter_add_reference on one (idx, g), with its
    times, its bound and its index stream's run structure."""
    from tensorf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_reference

    M, C = g.shape
    dev = g.device
    got = scatter_add(idx, g, n_rows)
    want = scatter_add_reference(idx, g, n_rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # fp32 sums in another order: allow 1e-6 of the largest sum of |g|
    # that lands on one output element, plus 1e-4
    abs_sum = scatter_add_reference(idx, g.abs(), n_rows)
    tol = 1e-4 + 1e-6 * float(abs_sum.max())
    del got, want, abs_sum
    lib_out = torch.zeros((n_rows, C), device=dev)
    reps = 10 if M * C > 50_000_000 else 30
    kernel_ms = time_ms(torch, lambda: scatter_add(idx, g, n_rows), reps)
    plain_ms = time_ms(torch, lambda: scatter_add_reference(idx, g, n_rows), reps)
    library_ms = time_ms(torch, lambda: lib_out.index_add_(0, idx, g), reps)
    del lib_out
    # g and idx read once, the output written once
    nbytes = M * C * 4 + M * 4 + n_rows * C * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = M * C / FP32_OPS_PER_S * 1e3
    mean_run, distinct64 = stream_stats(torch, idx)
    row = dict(
        case=name, M=M, n_rows=n_rows, C=C, max_abs_err=err, tol=tol,
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        mean_run=mean_run, distinct_per_64=distinct64,
    )
    print("kernel_case " + json.dumps(row), flush=True)
    check(err <= tol, f"scatter_add {name}: max |kernel - plain| {err} > {tol}")
    return row


def kernel_rays(torch, dev, scene):
    """4096 training rays of the scene, drawn from a seed: the batch whose
    sample lattice gives the density kernel cases their index streams."""
    from tensorf_tpu_torch.data.blender import BlenderDataset

    rays = BlenderDataset("", split="train", wh=SCENE["wh"], meta=scene["train"]).all_rays
    perm = torch.randperm(rays.shape[0], generator=torch.Generator().manual_seed(0))
    return torch.as_tensor(rays)[perm[:4096]].to(dev)


def synthetic_streams(torch, dev, rays):
    """(name, idx, g, n_rows) of each kernel case on a synthetic stream: the
    main path's shapes, then edge cases."""
    gen = torch.Generator(device=dev).manual_seed(0)
    B = rays.shape[0]
    cases = [
        # name, M, n_rows, C, index stream; the first four are the main
        # path's shapes: density over the full lattice, appearance over the
        # top-64 samples, at the 128^3 and 300^3 grid segments
        ("density_128", B * 443, 128 * 128, 64, ("lattice", 443, (128, 128, 128))),
        ("appearance_128", B * 64, 128 * 128, 192, ("uniform",)),
        ("density_300", B * 1039, 300 * 300, 64, ("lattice", 1039, (300, 300, 300))),
        ("appearance_300", B * 64, 300 * 300, 192, ("uniform",)),
        ("ragged_M", 1_000_003, 128 * 128, 64, ("uniform",)),
        ("odd_C", 65_537, 1000, 5, ("uniform",)),
        ("one_row", 262_144, 128 * 128, 64, ("one_row",)),
    ]
    for name, M, n_rows, C, stream in cases:
        if stream[0] == "lattice":
            idx = lattice_plane_indices(torch, rays, stream[1], stream[2], dev)
        elif stream[0] == "one_row":
            idx = torch.full((M,), n_rows // 2, dtype=torch.int32, device=dev)
        else:
            idx = torch.randint(0, n_rows, (M,), generator=gen, device=dev, dtype=torch.int32)
        check(idx.shape[0] == M, f"{name}: index stream has {idx.shape[0]} rows, want {M}")
        yield name, idx, torch.randn((M, C), generator=gen, device=dev), n_rows


def step_inputs(torch, dev, cfg, scene, field, grid):
    """A synth_full step's statics, batch, bbox and jitter for ``field``."""
    import numpy as np

    from tensorf_tpu_torch.data.blender import BlenderDataset
    from tensorf_tpu_torch.models import GridGeometry
    from tensorf_tpu_torch.models.config import cal_n_samples
    from tensorf_tpu_torch.train.losses import LossWeights
    from tensorf_tpu_torch.train.step import TrainStatics, draw_noise

    ds = BlenderDataset("", split="train", wh=SCENE["wh"], meta=scene["train"])
    aabb_np = ds.scene_bbox
    statics = TrainStatics(
        n_samples=cal_n_samples(grid, cfg.step_ratio),
        step_size=GridGeometry.create(aabb_np, grid, cfg.step_ratio).step_size,
        white_bg=True, ndc_ray=False, total_steps=cfg.n_iters, lr_factor=0.9999,
        weights=LossWeights(ortho=cfg.Ortho_weight, l1=cfg.L1_weight_inital,
                            tv_density=cfg.TV_weight_density, tv_app=cfg.TV_weight_app),
        free_reg=True, free_decomp=True, freq_reg_ratio=cfg.freq_reg_ratio,
        shade_top_k=cfg.prefilter_shade_top_k,
    )
    sel = np.random.default_rng(0).choice(ds.all_rays.shape[0], cfg.batch_size, replace=False)
    rays = torch.as_tensor(ds.all_rays[sel], device=dev)
    rgbs = torch.as_tensor(ds.all_rgbs[sel], device=dev)
    aabb = torch.as_tensor(aabb_np, device=dev)
    u, flip = draw_noise(torch.Generator(device=dev).manual_seed(2), cfg.batch_size, dev)
    return statics, aabb, rays, rgbs, u, flip


def step_parity_phase(torch, dev, cfg, scene):
    """One synth_full step's gradients, kernel vs plain, same inputs."""
    from unittest import mock

    from tensorf_tpu_torch.config import model_config_from
    from tensorf_tpu_torch.data.blender import BlenderDataset
    from tensorf_tpu_torch.models import TensorVMSplit
    from tensorf_tpu_torch.models.config import n_to_reso
    from tensorf_tpu_torch.ops import grid_sample
    from tensorf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_reference
    from tensorf_tpu_torch.train.step import loss_fn

    ds = BlenderDataset("", split="train", wh=SCENE["wh"], meta=scene["train"])
    grid = n_to_reso(cfg.N_voxel_init, ds.scene_bbox)
    field = TensorVMSplit(model_config_from(cfg), grid, dev, torch.Generator().manual_seed(1))
    statics, aabb, rays, rgbs, u, flip = step_inputs(torch, dev, cfg, scene, field, grid)

    def grads():
        field.zero_grad(set_to_none=True)
        total, _ = loss_fn(field, statics, aabb, rays, rgbs, 10, u, flip)
        total.backward()
        torch.cuda.synchronize()
        return total.item(), {n: p.grad.clone() for n, p in field.named_parameters()}

    before = scatter_add.launches
    loss_k, g_kernel = grads()
    check(scatter_add.launches - before == 6, "kernel step did not launch scatter_add 6 times")
    before = scatter_add.launches
    with mock.patch.object(grid_sample, "scatter_add", scatter_add_reference):
        loss_p, g_plain = grads()
    check(scatter_add.launches == before, "plain step launched the kernel")
    # the forward has no scatter: the two losses agree to rounding
    check(abs(loss_k - loss_p) <= 1e-6 * abs(loss_p), f"step losses differ: {loss_k} vs {loss_p}")
    worst = 0.0
    for name, gk in g_kernel.items():
        gp = g_plain[name]
        err = float((gk - gp).abs().max())
        # atomics sum in another order: 1e-4 of the leaf's largest gradient
        tol = 1e-4 * float(gp.abs().max()) + 1e-12
        check(err <= tol, f"step gradient {name}: max |kernel - plain| {err} > {tol}")
        worst = max(worst, err / tol)
    print(f"step_parity: loss {loss_k:.6f}, {len(g_kernel)} leaves, "
          f"max err/tol {worst:.3g} (tol = 1e-4 x max|grad| per leaf)", flush=True)


def capture_streams(torch, dev, cfg, scene, field, grid):
    """The index streams of a trained field: the (idx, g, n_rows) that the
    first density and the first appearance scatter-add of one more train
    step receive, recorded on their way to the kernel, by case name."""
    from unittest import mock

    from tensorf_tpu_torch.ops import grid_sample
    from tensorf_tpu_torch.ops.scatter_add import scatter_add
    from tensorf_tpu_torch.train.step import loss_fn

    statics, aabb, rays, rgbs, u, flip = step_inputs(torch, dev, cfg, scene, field, grid)
    seen = {}

    def recorder(idx, g, n_rows):
        seen.setdefault(g.shape[1], (idx.clone(), g.clone(), n_rows))
        return scatter_add(idx, g, n_rows)

    field.zero_grad(set_to_none=True)
    with mock.patch.object(grid_sample, "scatter_add", recorder):
        total, _ = loss_fn(field, statics, aabb, rays, rgbs, TRAIN_STEPS, u, flip)
        total.backward()
    torch.cuda.synchronize()
    field.zero_grad(set_to_none=True)
    widths = {"density": 4 * cfg.n_lamb_sigma[0], "appearance": 4 * cfg.n_lamb_sh[0]}
    check(set(seen) == set(widths.values()), f"recorded scatter widths {sorted(seen)}, "
          f"want {widths}")
    return {f"{kind}_{grid[0]}_real": seen[C] for kind, C in widths.items()}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script needs one NVIDIA GPU")
    try:
        from tensorf_tpu_torch.config import load_config
        from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
        from tensorf_tpu_torch.ops.scatter_add import KERNEL_NAME, KERNEL_SOURCE, scatter_add
        from tensorf_tpu_torch.train.loop import render_view, train_steps
        from tensorf_tpu_torch.utils.cuda_build import build
    except ImportError as exc:
        fail(f"run from the root of a tensorf_tpu checkout ({exc})")
    import numpy as np

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # name: (wrapper, source, TPU kernel replaced, grids each call enqueues)
    kernels = {KERNEL_NAME: (scatter_add, KERNEL_SOURCE, "tensorf_tpu/ops/pallas/scatter_add2.py:156",
                             ["zero_fill_kernel", "scatter_add_runs_kernel"])}
    t0 = time.perf_counter()
    built = build(list(kernels), force=True)
    print(f"build: {len(built)} kernel(s) with nvcc sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for res in built.values():
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build[{res.name}]: {line.strip()}", flush=True)
    print("kernels: " + ", ".join(f"{k} (cuda, {v[1]})" for k, v in kernels.items()), flush=True)

    # stratification and sample budgets are not ported yet: run without them
    cfg = load_config("configs/synth_full.txt",
                      dict(stratify=0, sample_budget=0, prefilter_budget=0))
    print(f"cuts: {SCENE['n_train']}/{SCENE['n_test']} train/test views (config scene 40/8), "
          f"{SCENE['wh'][0]}x{SCENE['wh'][1]} px (800x800), {TRAIN_STEPS} of {cfg.n_iters} "
          f"steps (first segment only); stratify, sample_budget, prefilter_budget 0 "
          f"(not ported); widths as configured", flush=True)
    scene = make_synthetic_scene_arrays(**SCENE)
    cases = [kernel_case(torch, *case)
             for case in synthetic_streams(torch, dev, kernel_rays(torch, dev, scene))]
    torch.cuda.empty_cache()

    step_parity_phase(torch, dev, cfg, scene)
    torch.cuda.empty_cache()

    # ---- the main path: counts to 0 just before, read just after ----
    for fn, *_ in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_steps(cfg, TRAIN_STEPS, device="cuda", scene=scene)
    wall_s = time.perf_counter() - t0
    launches = {k: v[0].launches for k, v in kernels.items()}
    print(f"main_path: {TRAIN_STEPS} steps + 1 test view in {wall_s:.2f} s, "
          f"{result.step_ms:.3f} ms/step (steps 2..{TRAIN_STEPS}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}", flush=True)
    for name, per_step in LAUNCHES_PER_STEP.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"{name} launched {launches[name]} times on the main path, "
              f"want {per_step} x {TRAIN_STEPS}")
    losses = np.asarray(result.total_loss)
    check(np.all(np.isfinite(losses)), "non-finite training loss")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    print(f"loss: first-5 mean {first:.6f} -> last-5 mean {last:.6f}", flush=True)
    check(last < 0.5 * first, "the training loss did not fall to half its start")
    check(result.test_rgb.shape == (SCENE["wh"][1], SCENE["wh"][0], 3), "test view shape")
    check(np.all(np.isfinite(result.test_rgb)) and math.isfinite(result.test_psnr),
          "non-finite test render")
    print(f"test_view: psnr {result.test_psnr:.4f} dB", flush=True)

    # ---- the rendered view against the CPU reference path ----
    import copy

    from tensorf_tpu_torch.data.blender import BlenderDataset
    from tensorf_tpu_torch.models.config import GridGeometry

    ds = BlenderDataset("", split="test", wh=SCENE["wh"], is_stack=True, meta=scene["test"])
    rays = torch.as_tensor(ds.all_rays[0][::156][:256])
    kw = dict(chunk=256, step_size=GridGeometry.create(ds.scene_bbox, result.grid_size, 0.5).step_size,
              n_samples=result.n_samples, is_train=False, white_bg=True,
              shade_top_k=cfg.shade_top_k, fused=True)
    aabb = torch.as_tensor(ds.scene_bbox)
    on_card = render_view(result.field, rays.to(dev), aabb=aabb.to(dev), **kw).cpu()
    on_cpu = render_view(copy.deepcopy(result.field).cpu(), rays, aabb=aabb, **kw)
    diff = (on_card - on_cpu).abs()
    err = float(diff.max())
    # float32 rounds differently on the two devices; a sample whose weight
    # sits at the shading threshold or at the K-th place of the top-K can
    # switch sides and move its pixel by about that weight, hence 1e-3
    print(f"reference: {rays.shape[0]} test rays, |card - cpu| max {err:.3g} "
          f"mean {float(diff.mean()):.3g} (tol 1e-3)", flush=True)
    check(err <= 1e-3, f"card render differs from the CPU reference by {err}")

    streams = capture_streams(torch, dev, cfg, scene, result.field, result.grid_size)
    cases += [kernel_case(torch, name, *stream) for name, stream in streams.items()]
    del streams

    # the headline numbers are density_128's, the main path's widest
    # scatter; "shapes" carries the other main-path shapes beside it.
    # "launches" counts calls of the kernel's entry point, each of which
    # enqueues the grids in "grids"; every time covers both.
    main_cases = [c for c in cases if c["case"] in MAIN_SHAPES]
    head = main_cases[0]
    line = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "grids": grids,
        "launches": launches[name],
        "max_abs_err": max(c["max_abs_err"] for c in main_cases),
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shapes": [{k: c[k] for k in ("case", "kernel_ms", "plain_ms", "bound_ms", "library_ms")}
                   for c in main_cases],
    } for name, (_, src, replaces, grids) in kernels.items()]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
