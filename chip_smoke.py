#!/usr/bin/env python3
"""Drive tensorf_tpu_torch's main path on one NVIDIA GPU and hold every
CUDA kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits non-zero, no phase is caught and passed over;
each prints its seconds):
  1. build every kernel of the path from the checkout's sources with nvcc
     (sm_90a), all at once;
  2. kernel phase: each kernel against its plain version on the card, at the
     shapes the main path gives it plus edge cases, with its times; the
     bf16 entry point on the same values in bf16 (the main path's shapes,
     ragged_M, odd_C, one_row) and on its own branches (C = 12, rows 8
     bytes off a 16-byte boundary), each bf16 case timed in turns with the
     float32 entry point on the same values widened (vs_f32) and beside its
     bound (share);
  3. step parity: one synth_full train step with the kernels and one with
     the plain versions, same params, batch and jitter; gradients must agree;
  4. main path: ``reconstruction`` of configs/synth_full.txt as written
     (ray stratification, sample budgets 160/384, top-32 shading,
     stratified serving in every evaluation) at full width (ranks 16/48, app_dim 27, MLP_Fea
     128, batch 4096) on an in-memory composite scene, through a cut
     coarse-to-fine schedule: 128^3 until iteration 200, the two alpha-mask
     events (shrink at the first, ray re-filtering at the second), five
     upsamples to n_to_reso(300^3) on the shrunk bbox, a restratification
     of the ray store after every event, test-set PSNR at 200 and at the
     end, a final checkpoint.  Every plan and each stratum's overflow at
     every progress read are printed.  The loss must halve over the first
     200 steps, the kernel must launch as often as each step's strata call
     for, every segment must be stratified, no stratum may overflow more
     than 1% at the last read, the grids must follow the voxel schedule,
     the final PSNR must beat the one at 200 and no evaluation may
     overflow a sample budget (each one's largest overflow is printed);
  5. exactness: on 256 test rays of the final state, each stratum of their
     own plan rendered at its candidate budget and chord lattice, and the
     rays the eval budget covers rendered in "alive" mode at it, against
     the unbudgeted masked render (depth 1e-4, rgb 1e-5 but for shading
     flips: see same_render); the masked render against the CPU path; the
     final checkpoint re-rendered through the render-only entry; the same
     rays rendered with every dtype option at bfloat16 against float32,
     within BF16_RENDER_BAR (bf16_render);
  6. serving at full width: one 800x800 view of the final state (test pose
     0 with the focal scaled x4: the synth_full/Blender test resolution,
     640,000 rays built on the card by rays_from_pose) served by
     render_chunked_stratified (window bits, device-resident) against the
     unbudgeted uniform render_chunked (the same tolerances, overflow
     exactly 0.0), both through the eval's RendererHandle; the same frame
     from host rays must be identical; the legacy path (no coarse gate,
     and with the exact-alive stage) against the uniform render on the
     200x200 test view.  Prints the bucket table (tier, budget K, lattice,
     rays, chunks), the zero-skipped rays, the shading flips and ms per
     frame of both renders (CUDA events, after a warm frame);
  7. the unstratified drive: the same schedule with stratification and
     budgets off, as the port ran before it had them, with the same checks;
  8. the kernel against its plain version on the real index streams: the
     (idx, g) that one more train step hands to the first density and the
     first appearance scatter-add — of the unstratified drive's 128^3 field
     at iteration 200 and of its final field, and of the largest and the
     smallest stratum (by samples a step) of the main path's final plan;
  9. a second path: configs/synth_sphere.txt's schedule as written (300
     steps, events at 150/200/260, stratified serving) on the in-memory
     sphere scene at 800x800 with downsample 8, at each of the five seeds
     of seed_spread.SEEDS (the config's first, which feeds phases 10 and
     11); each seed's test PSNR is printed, their mean must reach 30 dB
     (sphere_seed_mean) and no evaluation may overflow;
 10. mesh: the CLI's mesh export (``--export_mesh 1 --ckpt``) of the main
     path's final checkpoint (its n_to_reso(300^3) grid, before the
     unstratified drive replaces that logfolder) and of synth_sphere's: each
     writes its .ply and nothing else, launches no kernel (no train step),
     and runs the native marching library; the sphere's mean vertex radius
     about its centre must lie within 0.05 of 0.8.  Prints vertex and face
     counts, the alpha grid's ms (host clock, device synchronised) and the
     host ms of marching.  th_import: the main path's final field written
     in the reference's .th layout (write_reference_th); render-only of the
     .th through the CLI must read the .npz's PSNR within 1e-4 dB, and its
     mesh export as many vertices as mesh_main's;
 11. resume: the config seed's synth_sphere run of phase 9 leaves, after
     step 251 (its checkpoint at 250 the newest), a copy of its logfolder:
     what a kill after that step leaves on disk.  ``resume`` in that copy
     must log that it continues at 251 with the optimizer and sampling
     state restored, what it loads must equal the checkpoint exactly, its
     history.npz must hold the row at 250, and its final test PSNR must lie
     within 0.5 dB of the run it was copied from.  Both share the same 251
     steps: float atomics sum in another order on each run, so only the
     last 49 drift apart in rounding (two separate runs at one seed spread
     on the card by as much as the bar);
 12. lego_path: ``reconstruction`` of configs/lego.txt as written
     (TensorCP, ranks 16/48, app_dim 27, MLP shading with pos/view/fea PE
     2 and featureC 128, batch 1024, sample_budget 160, stratify and
     stratify_render, downsample 2, the FreeNeRF, occlusion and L1 terms)
     on the composite scene with Blender's 100/200 views at 800x800, its
     schedule cut to 600 steps (profile_step.LEGO_CUT: the upsample and
     alpha mask at 2000 move to 400).  TensorCP has no plane, so its steps
     launch no scatter-add: one step's gradients on the card are held to
     the same step on the CPU (rtol/atol 1e-4) instead, and the run must
     launch the kernel 0 times, the per-stratum sum.  Every segment
     stratified, the loss no higher than LEGO_LOSS_RATIO of its start by
     400 (as written the L1 term holds the density at its initial plateau
     on this scene, in both packages), every eval overflow 0.0, the final
     checkpoint re-rendered through render_test on the selected test views
     within 1e-4 dB; then its mesh export (as phase 10, an empty mesh
     allowed).  Then lego_l1_off: the first LEGO_L1_OFF_STEPS steps of the
     same segment with the L1 weights at 0, whose loss must fall to
     LEGO_L1_OFF_LOSS_RATIO and whose test view must beat the untrained
     field's.  Prints its
     segments' ms/step and peak GiB;
 13. tensorvm: configs/synth_full.txt with ``model_name`` TensorVM over the
     main path's first segment (200 steps at 128^3, full width: 64-channel
     planes): one step's gradients kernel vs plain, launches equal to the
     per-stratum sum, the loss halved; then the kernel against its plain
     version on the index streams its last step hands it (the top-K
     path's density and appearance tables at 128^3);
 14. shading: SH, RGB, MLP_PE and MLP heads on configs/synth_sphere.txt's
     first segment (its first SHADING_STEPS steps): for each, one step's
     gradients kernel vs plain, launches equal to the per-stratum sum, a
     falling loss, and a test PSNR above the untrained field's;
 15. flower: configs/flower.txt (LLFF, NDC rays) at full width
     (TensorVMSplit [16,4,4]/[48,12,12], app_dim 27, MLP_Fea, batch 4096) on
     an in-memory forward-facing capture of 34 views at 1008x756 (flower's
     images_4 size: 29 train, 5 test), its schedule cut to 450 steps
     (profile_step.FLOWER_CUT: four upsamples to n_to_reso(640^3), the mask
     at 250).  flower_parity: one first-segment step kernel vs plain (the
     same 1e-4-of-max rule, launches per scatter_launches_per_step) and
     card vs CPU (rtol/atol 1e-4).  flower_path: every segment's grid,
     samples a step, line implementation (one-hot matmul or footprint
     gather, models/tensorf.py::line_uses_matmul), ms/step and peak GiB;
     the last segment's lines must take the footprint; the loss must fall
     to FLOWER_LOSS_RATIO by 200.  flower_serving: the test views served
     uniform through the eval's handle on render-only's lattice (the
     geometry's; the run's differs by a few samples, which moves every NDC
     sample), ms per frame, their PSNR above the untrained field's and
     FLOWER_MIN_PSNR; FLOWER_SPIRAL spiral poses; render-only of the final
     checkpoint within 1e-4 dB of the served views (render-only scores
     every test view, the handle serves FLOWER_SERVED).  Then the kernel
     against its plain version on the last segment's plane and line
     footprint streams;
 16. bf16: configs/synth_full.txt as written but with grid_dtype,
     line_dtype and compute_dtype bfloat16 (profile_step.BF16) over the
     main path's first segment (BF16_STEPS at 128^3): one step's gradients
     kernel vs plain (2^-6 of each leaf's largest: bf16 rounding of the
     summed rows), launches of scatter_add and of its bf16 entry point
     (scatter_add_bf16) equal to the per-stratum sums, the main path's loss
     bar, its segment's ms/step and peak GiB; then the bf16 entry point
     against its plain version on the density and appearance streams of
     the last step's largest stratum, beside the float32 entry point on
     the same values widened;
 17. lpips: AlexNet and VGG LPIPS (eval/lpips.py) with seeded random
     weights in a temporary TENSORF_LPIPS_DIR on an 800x800 view (the
     sphere scene's test view 0 against a noisy copy), the card against
     the CPU within LPIPS_RTOL, with ms per call;
 18. dp_step_parity: synth_full's first step at full width on DP_RANKS
     gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card)
     against one rank, from an Adam state in progress: parameters within
     rel 1e-5 / abs 1e-6 and bit-identical on the ranks, the kernel
     launched on each rank as often as on one, on its share of the rows;
 19. dp_path: ``reconstruction`` of the main path's config and cut
     schedule on those ranks (parallel/parity.py::reconstruct, each rank's
     counts set to 0 just before and read just after): plan and event
     lines and parameter checksums equal on the ranks after every event,
     every eval overflow 0.0, each rank's launches the per-stratum sum of
     its shares, the final PSNR within DP_MAX_DPSNR of the main path's;
     each rank's ms/step and peak GiB;
 20. dp_nccl: the CLI with ``--distributed 1`` at world size 1 through
     the TFTPU_* variables, NCCL on the card, DP_NCCL_STEPS steps; with
     two or more cards, ``--n_devices min(4, count)`` over NCCL too (with
     one, a line says it was not run).
Each kernel case also prints its index stream's mean run length and mean
distinct rows per 64-row tile: what the kernel's run aggregation exploits.

Cuts (each is printed): 8 train and 2 test views instead of 40 and 8,
200x200 pixels instead of 800x800, and synth_full's 30000-step schedule cut
to 450 steps with its events at 200-400, the LR decay of the 30000 and a
progress read every 25 steps (profile_step.CUT_SCHEDULE); lego's
3000-step schedule cut to 600 with its event at 400, the LR decay of the
3000, and its final state scored (profile_step.LEGO_CUT); flower's 25000
steps cut to 450 (profile_step.FLOWER_CUT), its final render and its
render_path moved to flower_serving (the spiral cut to FLOWER_SPIRAL of 120
poses, the served test views to FLOWER_SERVED: the data-parallel phases'
time).

Without a GPU, or outside a checkout of the repo, it exits non-zero and
prints no result.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SCENE = dict(n_train=8, n_test=2, wh=(200, 200), scene="composite")
# configs/synth_sphere.txt's own scene: 10/2 views at 800x800, downsample 8
SPHERE = dict(n_train=10, n_test=2, wh=(800, 800), scene="sphere")
# A fresh synth_full field's loss sits on a plateau for its first ~140
# steps at 128^3 (density starts near zero under density_shift -10 and the
# FreeNeRF masks open slowly), then falls steeply: the first segment's 200
# steps show the fall.
FIRST_SEGMENT = 200
# synth_full's unstratified step shades the top-K samples: 3 density + 3
# appearance planes
UNSTRATIFIED_LAUNCHES_PER_STEP = 6
# the synthetic cases of the main path's shapes; the real streams join them
SYNTHETIC_MAIN_SHAPES = ("density_128", "appearance_128", "density_300", "appearance_300")
# the synthetic cases that also run in bf16 (the same values): the main
# path's shapes, then the bf16 entry point's other branches (ragged M, one
# channel a thread, a hot row); bf16_branch_streams adds C = 12 and a g 8
# bytes off a 16-byte boundary
BF16_SYNTHETIC = SYNTHETIC_MAIN_SHAPES + ("ragged_M", "odd_C", "one_row")
# the JAX package's drive of synth_sphere is held to >= 30 dB (its verify
# notes); one run's PSNR spreads across that bar with the seed (29.59-32.50
# dB for JAX's CPU drive, 27.79-31.90 for the port's) and, on the card,
# from call to call (29.86-30.22 dB at one seed; ROADMAP queue 3 item 6),
# so the bar holds the mean over seed_spread.SEEDS, which both packages'
# CPU drives meet (PERF.md §6: JAX 30.78, the port 30.59 dB)
SPHERE_MIN_PSNR = 30.0
SPHERE_JAX_MEAN = 30.78
SPHERE_PORT_CPU_MEAN = 30.59
# a stratum whose last overflow read is above this fails the main path
MAX_FINAL_OVERFLOW = 0.01
# data/synthetic.py's sphere: radius 0.8 about the origin
SPHERE_RADIUS = 0.8
MESH_RADIUS_TOL = 0.05
# the sphere run's logfolder is copied after this step (what a kill there
# leaves: the checkpoint at 250 the newest); the copy's resumed final test
# PSNR lies within this many dB of the run it was copied from
RESUME_KILL = 251
RESUME_MAX_DPSNR = 0.5
# configs/lego.txt's path (profile_step.LEGO_CUT): its first segment runs
# to the upsample and alpha mask at 400.  The bars compare the mean loss of
# the segment's last 5 steps with that of its first 5, and come from the
# port's CPU drives of the same path (PERF.md §6 PR 7): as written the loss
# stays on its initial plateau (ratio 1.096), so it may not rise past
# LEGO_LOSS_RATIO; with the L1 weights at 0 it falls (ratio
# 0.112) and must reach LEGO_L1_OFF_LOSS_RATIO.  lego_l1_off runs the first
# LEGO_L1_OFF_STEPS of those steps: its loss leaves the plateau by step ~60
# (the card read 0.0136 at step 160 against 0.098 at the start; PERF.md
# §6), and the time goes to flower
LEGO_FIRST_SEGMENT = 400
LEGO_L1_OFF_STEPS = 200
LEGO_LOSS_RATIO = 1.25
LEGO_L1_OFF_LOSS_RATIO = 0.5
# configs/synth_full.txt with --model_name TensorVM over the first segment
# of the main path (200 steps at 128^3); its loss must halve, as the main
# path's does (the CPU drive in PERF.md)
TENSORVM_LOSS_RATIO = 0.5
# the shading modes of the shading phase, each with the data_dim_color it
# needs (SH 3 x 9 coefficients, RGB the colour itself; the MLP heads take
# synth_sphere's 9), over the first SHADING_STEPS of synth_sphere's first
# segment (150 steps): every head's loss had fallen by 150 to 0.02–0.05 of
# its start (PERF.md §6), and the time goes to flower
SHADING_MODES = {"SH": 27, "RGB": 3, "MLP_PE": None, "MLP": None}
SHADING_STEPS = 100
# configs/flower.txt's path (profile_step.FLOWER_CUT): its first segment
# runs to the upsample at 200.  The bars come from the port's CPU drive of
# the same path at a reduced size (PERF.md §6): the loss over the first
# segment must fall to FLOWER_LOSS_RATIO of its start, and the final test
# PSNR reach FLOWER_MIN_PSNR
FLOWER_FIRST_SEGMENT = 200
FLOWER_LOSS_RATIO = 0.5
FLOWER_MIN_PSNR = 26.0
# spiral render_path poses flower_serving renders, of the loader's 120, and
# the test views it serves through the eval's handle beside render-only's
# (cut from 2 and all 5 for the data-parallel phases' time: each is ~23 s)
FLOWER_SPIRAL = 1
FLOWER_SERVED = 1
# the bf16 path: synth_full with every dtype option at bfloat16 over the
# main path's first segment, held to its loss bar; a bf16 render of the
# main path's final state within JAX's bar for a bf16 grid against the
# float32 render (tests/test_render.py)
BF16_STEPS = FIRST_SEGMENT
BF16_RENDER_BAR = 0.03
# LPIPS on the card against the CPU: float32 convolutions in both, summed
# in other orders
LPIPS_RTOL = 1e-4
# the data-parallel phases: ranks sharing the one card over gloo (NCCL
# refuses two ranks on one card); the dp path's final test PSNR within
# DP_MAX_DPSNR of the main path's (the ranks sum the gradient in another
# order, and float atomics differ from run to run, as two clean runs do);
# dp_nccl's steps through --distributed 1 at world size 1
DP_RANKS = 2
DP_MAX_DPSNR = 0.5
DP_NCCL_STEPS = 20
# each data-parallel launch's bound, and its collectives'
DP_TIMEOUT_S = 900.0
DP_COLLECTIVE_TIMEOUT_S = 600.0
# the keys of each kernel case in the kernels line
CASE_KEYS = ("case", "M", "dtype", "kernel_ms", "plain_ms", "bound_ms", "library_ms", "share",
             "vs_f32")
# scatter widths: 4 taps x ranks 16 (density), 48 (appearance)
STREAM_KINDS = {64: "density", 192: "appearance"}
# flower's fused step (ranks [16,4,4]/[48,12,12]): the density's plane
# footprint tables, 4 taps x 16 (axis 0) and x 4 (axes 1, 2), and its line
# footprint tables, 2 taps x the same; the shaded samples' appearance taps,
# gathered row by row, 48 and 12 wide (the first stream of each width that
# the backward scatters)
FLOWER_STREAMS = {64: "plane0", 16: "plane12", 32: "line0", 8: "line12", 48: "app0",
                  12: "app12"}
# the eval's chunk (tensorf_tpu evaluation's default), and the uniform
# render's: the unbudgeted ~1048-sample lattice of 4096 rays is the
# unstratified train step's width
SERVE_CHUNK = 8192
UNIFORM_CHUNK = 4096
# A render that keeps the same samples as the unbudgeted one sums their
# weights in another float32 order, so a weight within ~1 ulp of the shading
# threshold or of its neighbour at the top-K cut can be shaded in one render
# and not the other, moving its pixel by up to that weight (about 1e-4 at
# the threshold).  Such a decision is a flip when its relative distance to
# the other side is within this margin.
FLIP_MARGIN = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase_done(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


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
    """scatter_add against scatter_add_reference on one (idx, g), float32
    or bf16 (the bf16 entry point), with its times, its bound and its index
    stream's run structure.  A bf16 case also times the float32 entry point
    on the same values widened, in turns with its own (bf16, float32,
    float32, bf16), and reports ``vs_f32``, its mean time over that one's;
    ``share`` is the bound over the kernel's time."""
    from tensorf_tpu_torch.ops.scatter_add import scatter_add, scatter_add_reference

    idx, g = idx.cuda(), g.cuda()
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
    # index_add_ takes a source of its table's dtype: a bf16 g widened once,
    # outside the timed call (the float32 entry point's input too)
    lib_g = g.float()
    reps = 10 if M * C > 50_000_000 else 30
    f32_ms = None
    if g.dtype == torch.bfloat16:
        turns = [time_ms(torch, lambda: scatter_add(idx, g, n_rows), reps),
                 time_ms(torch, lambda: scatter_add(idx, lib_g, n_rows), reps),
                 time_ms(torch, lambda: scatter_add(idx, lib_g, n_rows), reps),
                 time_ms(torch, lambda: scatter_add(idx, g, n_rows), reps)]
        kernel_ms, f32_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    else:
        kernel_ms = time_ms(torch, lambda: scatter_add(idx, g, n_rows), reps)
    plain_ms = time_ms(torch, lambda: scatter_add_reference(idx, g, n_rows), reps)
    library_ms = time_ms(torch, lambda: lib_out.index_add_(0, idx, lib_g), reps)
    del lib_out, lib_g
    # g (4 or 2 bytes a value) and idx read once, the fp32 output written once
    nbytes = M * C * g.element_size() + M * 4 + n_rows * C * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = M * C / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    mean_run, distinct64 = stream_stats(torch, idx)
    row = dict(
        case=name, M=M, n_rows=n_rows, C=C, dtype=str(g.dtype).replace("torch.", ""),
        max_abs_err=err, tol=tol,
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        share=bound_ms / kernel_ms, mean_run=mean_run, distinct_per_64=distinct64,
    )
    if f32_ms is not None:
        row.update(f32_ms=f32_ms, vs_f32=kernel_ms / f32_ms)
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


def bf16_branch_streams(torch, dev):
    """(name, idx, g, n_rows) of the bf16 entry point's branches that no
    float32 case has: four-channel columns at C = 12, and a g whose rows
    start 8 bytes off a 16-byte boundary (8-byte loads, four channels)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    M = 262_144
    idx = torch.randint(0, 128 * 128, (M,), generator=gen, device=dev, dtype=torch.int32)
    yield "C12_bf16", idx, torch.randn((M, 12), generator=gen, device=dev).to(torch.bfloat16), \
        128 * 128
    M = 1_000_003
    flat = torch.randn((M * 64 + 4,), generator=gen, device=dev).to(torch.bfloat16)
    g = flat[4:].view(M, 64)
    check(g.is_contiguous() and g.data_ptr() % 16 == 8, "unaligned8_bf16: g is not 8 bytes off")
    idx = torch.randint(0, 128 * 128, (M,), generator=gen, device=dev, dtype=torch.int32)
    yield "unaligned8_bf16", idx, g, 128 * 128


def step_inputs(torch, dev, cfg, scene, grid):
    """A first-segment step's statics (unstratified, the prefilter top-K),
    batch, bbox and jitter on ``dev``: the path's train split as its run
    loads it, a batch and the jitter drawn from seeds."""
    import numpy as np

    from tensorf_tpu_torch.models import GridGeometry
    from tensorf_tpu_torch.models.config import cal_n_samples
    from tensorf_tpu_torch.train.loop import _dataset
    from tensorf_tpu_torch.train.losses import LossWeights
    from tensorf_tpu_torch.train.step import TrainStatics, draw_noise

    ds = _dataset(cfg, scene, "train", num_images=cfg.resolved_train_images())
    aabb_np = ds.scene_bbox
    n_samples = min(int(cfg.nSamples), cal_n_samples(grid, cfg.step_ratio))
    statics = TrainStatics(
        n_samples=n_samples,
        step_size=GridGeometry.create(aabb_np, grid, cfg.step_ratio).step_size,
        white_bg=ds.white_bg, ndc_ray=bool(cfg.ndc_ray), total_steps=cfg.n_iters,
        lr_factor=0.9999,
        # the loop's weights: ortho for the VM models only
        weights=LossWeights(ortho=cfg.Ortho_weight if "VM" in cfg.model_name else 0.0,
                            l1=cfg.L1_weight_inital, tv_density=cfg.TV_weight_density,
                            tv_app=cfg.TV_weight_app, occ=cfg.occ_reg_loss_mult,
                            occ_range=cfg.occ_reg_range, occ_wb_range=cfg.occ_wb_range,
                            occ_wb_prior=bool(cfg.occ_wb_prior)),
        free_reg=bool(cfg.free_reg), free_decomp=bool(cfg.free_decomp),
        freq_reg_ratio=cfg.freq_reg_ratio, shade_top_k=cfg.prefilter_shade_top_k,
    )
    sel = np.random.default_rng(0).choice(ds.all_rays.shape[0], cfg.batch_size, replace=False)
    rays = torch.as_tensor(ds.all_rays[sel], device=dev)
    rgbs = torch.as_tensor(ds.all_rgbs[sel], device=dev)
    aabb = torch.as_tensor(aabb_np, device=dev)
    # NDC rays jitter each sample
    u, flip = draw_noise(torch.Generator(device=dev).manual_seed(2), cfg.batch_size, dev,
                         n_samples if cfg.ndc_ray else 1)
    return statics, aabb, rays, rgbs, u, flip


def path_field(torch, dev, cfg, scene, seed=1):
    """A fresh field of ``cfg``'s model at full width on the path's first
    grid, drawn from ``seed``, and that grid."""
    from tensorf_tpu_torch.config import model_config_from
    from tensorf_tpu_torch.models import FIELD_MODELS
    from tensorf_tpu_torch.models.config import n_to_reso
    from tensorf_tpu_torch.train.loop import _dataset

    ds = _dataset(cfg, scene, "test", num_images=[0])
    grid = n_to_reso(cfg.N_voxel_init, ds.scene_bbox)
    # the dataset's near/far, as the loop sets it
    model_cfg = model_config_from(cfg).replace(near_far=tuple(float(v) for v in ds.near_far))
    field = FIELD_MODELS[cfg.model_name](model_cfg, grid, dev,
                                         torch.Generator().manual_seed(seed))
    return field, grid


def step_grads(torch, field, statics, aabb, rays, rgbs, u, flip):
    """One step's total loss and every leaf's gradient."""
    from tensorf_tpu_torch.train.step import loss_fn

    field.zero_grad(set_to_none=True)
    total, _ = loss_fn(field, statics, aabb, rays, rgbs, 10, u, flip)
    total.backward()
    if aabb.is_cuda:
        torch.cuda.synchronize()
    return total.item(), {n: p.grad.clone() for n, p in field.named_parameters()}


def step_parity_phase(torch, dev, cfg, scene, label="step_parity", rel=1e-4):
    """One first-segment step's gradients of ``cfg``'s model, kernel vs
    plain, same inputs: each leaf within ``rel`` of its largest plain
    gradient."""
    from unittest import mock

    from tensorf_tpu_torch.ops import grid_sample
    from tensorf_tpu_torch.ops.scatter_add import (scatter_add, scatter_add_bf16,
                                                   scatter_add_reference)
    from tensorf_tpu_torch.parallel import parity

    field, grid = path_field(torch, dev, cfg, scene)
    statics, aabb, rays, rgbs, u, flip = step_inputs(torch, dev, cfg, scene, grid)
    inputs = (statics, aabb, rays, rgbs, u, flip)

    before = (scatter_add.launches, scatter_add_bf16.launches)
    with parity.recording_shaded() as shaded:
        loss_k, g_kernel = step_grads(torch, field, *inputs)
    want = (scatter_launches_per_step(statics, cfg.model_name, [cfg.batch_size], grid,
                                      field.line_a_dtype, shaded, field.grid_dtype),
            bf16_launches_per_step(statics, cfg.model_name, [cfg.batch_size], field.grid_dtype,
                                   shaded))
    got = (scatter_add.launches - before[0], scatter_add_bf16.launches - before[1])
    check(got == want, f"{label}: the kernel step launched (scatter_add, scatter_add_bf16) "
          f"{got} times, not {want}")
    before = scatter_add.launches
    with mock.patch.object(grid_sample, "scatter_add", scatter_add_reference):
        loss_p, g_plain = step_grads(torch, field, *inputs)
    check(scatter_add.launches == before, f"{label}: the plain step launched the kernel")
    # the forward has no scatter: the two losses agree to rounding
    check(abs(loss_k - loss_p) <= 1e-6 * abs(loss_p),
          f"{label}: step losses differ: {loss_k} vs {loss_p}")
    worst = 0.0
    for name, gk in g_kernel.items():
        gp = g_plain[name]
        err = float((gk - gp).abs().max())
        # atomics sum in another order: ``rel`` of the leaf's largest gradient
        tol = rel * float(gp.abs().max()) + 1e-12
        check(err <= tol, f"{label} gradient {name}: max |kernel - plain| {err} > {tol}")
        worst = max(worst, err / tol)
    print(f"{label}: {cfg.model_name} {cfg.shadingMode}, (scatter_add, scatter_add_bf16) "
          f"{want} launches a step, loss {loss_k:.6f}, {len(g_kernel)} leaves, max err/tol "
          f"{worst:.3g} (tol = {rel:g} x max|grad| per leaf)", flush=True)


def device_parity_phase(torch, cfg, scene, label):
    """One first-segment step's gradients of ``cfg``'s model on the card
    against the same step on the CPU, within rtol/atol 1e-4 elementwise:
    for a path that launches no kernel, this holds its card run to the
    plain path."""
    import copy

    dev = torch.device("cuda")
    field, grid = path_field(torch, dev, cfg, scene)
    inputs = step_inputs(torch, dev, cfg, scene, grid)
    loss_c, g_card = step_grads(torch, field, *inputs)
    on_cpu = [x.cpu() if isinstance(x, torch.Tensor) else x for x in inputs]
    loss_h, g_host = step_grads(torch, copy.deepcopy(field).cpu(), *on_cpu)
    check(abs(loss_c - loss_h) <= 1e-4 * abs(loss_h) + 1e-4,
          f"{label}: step loss {loss_c} on the card, {loss_h} on the CPU")
    worst, worst_name = 0.0, None
    for name, gc in g_card.items():
        gh = g_host[name]
        excess = float(((gc.cpu() - gh).abs() - (1e-4 + 1e-4 * gh.abs())).max())
        if worst_name is None or excess > worst:
            worst, worst_name = excess, name
        check(excess <= 0.0, f"{label} gradient {name}: |card - cpu| exceeds 1e-4 + 1e-4 |cpu| "
              f"by {excess:.3g}")
    print(f"{label}: {cfg.model_name} {cfg.shadingMode} at {grid}, batch {cfg.batch_size}: "
          f"loss card {loss_c:.6f} cpu {loss_h:.6f}; {len(g_card)} leaves within rtol/atol "
          f"1e-4 elementwise (closest: {worst_name}, {worst:.3g} below the bound)", flush=True)


def capture_streams(torch, state, suffix, stratum=None, kinds=STREAM_KINDS, **statics_over):
    """The index streams of the field in ``state``: the (idx, g, n_rows)
    that the first scatter-add of each width (density, appearance, or both
    fused; ``kinds`` names them by width) of one more train step (the
    segment's statics, its mask) receives, by case name, on the host.  With
    ``stratum`` the step is that stratum's sub-batch alone, at its quota,
    budget and lattice; ``statics_over``
    replaces fields of the step's statics.  The step's backward runs the
    plain version, so capturing launches no kernel."""
    from unittest import mock

    from tensorf_tpu_torch.ops import grid_sample
    from tensorf_tpu_torch.ops.scatter_add import scatter_add_reference
    from tensorf_tpu_torch.train.loop import build_statics
    from tensorf_tpu_torch.train.step import draw_noise, loss_fn

    dev, cfg = state.device, state.cfg
    statics = build_statics(state)._replace(**statics_over)
    gen = torch.Generator().manual_seed(0)
    if stratum is None:
        ids = torch.randperm(state.rays.shape[0], generator=gen)[: cfg.batch_size].to(dev)
        u, flip = draw_noise(torch.Generator(device=dev).manual_seed(2), cfg.batch_size, dev,
                             statics.n_samples if statics.ndc_ray else 1)
        batch = (state.rays[ids], state.rgbs[ids], u, flip)
    else:
        def one(field):
            return None if field is None else (field[stratum],)

        statics = statics._replace(
            strata_budgets=one(statics.strata_budgets),
            strata_alive_budgets=one(statics.strata_alive_budgets),
            strata_n_samples=one(statics.strata_n_samples),
            strata_loss_weights=None, strata_noise_match=False)
        members, quota = state.sampler.strata[stratum], state.quotas[stratum]
        reps = -(-quota // members.shape[0])
        pick = torch.cat([torch.randperm(members.shape[0], generator=gen) for _ in range(reps)])
        ids = members[pick[:quota]].to(dev)
        u, flip = draw_noise(torch.Generator(device=dev).manual_seed(2), quota, dev)
        batch = ((state.rays[ids],), (state.rgbs[ids],), (u,), (flip,))
    seen = {}

    def recorder(idx, g, n_rows):
        # kept on the host: the 640^3-era streams are ~10 GB beside the step
        if g.shape[1] not in seen:
            seen[g.shape[1]] = (idx.cpu(), g.cpu(), n_rows)
        return scatter_add_reference(idx, g, n_rows)

    field = state.field
    field.zero_grad(set_to_none=True)
    with mock.patch.object(grid_sample, "scatter_add", recorder):
        total, _ = loss_fn(field, statics, state.aabb, *batch[:2], cfg.n_iters - 1, *batch[2:],
                           state.alpha_mask)
        total.backward()
    torch.cuda.synchronize()
    field.zero_grad(set_to_none=True)
    check(seen and set(seen) <= set(kinds), f"recorded scatter widths {sorted(seen)}")
    return {f"{kinds[C]}_{suffix}": stream for C, stream in seen.items()}


def check_schedule(result, cfg):
    """The grids follow n_voxel_schedule on the aabb of each upsample (the
    shrunk one), the last is n_to_reso(N_voxel_final), and every event
    fired in order."""
    from tensorf_tpu_torch.models.config import n_to_reso, n_voxel_schedule

    kinds = [(e["iteration"], e["event"]) for e in result.events]
    want = sorted([(i, "alpha_mask") for i in cfg.update_AlphaMask_list]
                  + [(i, "upsample") for i in cfg.upsamp_list])
    check(kinds == want, f"schedule events {kinds}, want {want}")
    ups = [e for e in result.events if e["event"] == "upsample"]
    counts = n_voxel_schedule(cfg.N_voxel_init, cfg.N_voxel_final, len(cfg.upsamp_list))
    for e, n in zip(ups, counts):
        want_grid = n_to_reso(n, e["aabb"])
        check(e["n_voxels"] == n and tuple(e["grid"]) == want_grid,
              f"upsample at {e['iteration']}: grid {e['grid']} for {e['n_voxels']} voxels, "
              f"want {want_grid} for {n}")
    final_aabb = result.state.geometry.aabb_np
    want_final = n_to_reso(cfg.N_voxel_final, final_aabb)
    check(tuple(result.state.geometry.grid_size) == want_final,
          f"final grid {result.state.geometry.grid_size}, want n_to_reso("
          f"{cfg.N_voxel_final}, {final_aabb.tolist()}) = {want_final}")
    shrink = result.events[[k for _, k in kinds].index("alpha_mask")]
    check("shrink_grid" in shrink, "the first alpha-mask event did not shrink")
    check(any(e.get("refiltered") for e in result.events), "no alpha ray re-filtering")


def appearance_rows(statics, batches, shaded=None) -> list:
    """The rows each render of a step gathers appearance for: its rays x
    the top K where top-K shading is below the render's width, else the
    render's samples whose weight passes the threshold, ``shaded[r]`` (what
    ``parity.recording_shaded`` read back; needed only for such a render)."""
    from tensorf_tpu_torch.train.step import render_widths

    k = statics.shade_top_k
    rows = []
    for r, (b, w) in enumerate(zip(batches, render_widths(statics))):
        if k is not None and k < w:
            rows.append(b * k)
        elif shaded is None:
            raise ValueError("a render without top-K shading shades the samples over the "
                             "threshold: pass each render's count as ``shaded``")
        else:
            rows.append(int(shaded[r]))
    return rows


def scatter_launches_per_step(statics, model_name: str, batches, grid, a_dtype=None,
                              shaded=None, grid_dtype=None) -> int:
    """The scatter-adds one train step of ``model_name`` launches under
    ``statics`` with ``batches`` rays in each render (the strata's quotas,
    or the batch) on a ``grid`` (X, Y, Z): one per gathered table.  Each
    render gathers density over its width and appearance apart, over the
    rows of ``appearance_rows`` (``shaded``: see there); a pass over no rows
    launches nothing.  The fused path gathers each pass's three plane tables
    (TensorCP has none) and samples its three lines by the one-hot matmul,
    which scatters nothing, except a line that models/tensorf.py's
    line_uses_matmul sends to the footprint gather at that pass's points.
    Unfused, every plane and line is a row gather of its own: 6 a pass for
    the VM models, CP's 3 lines; so are the shaded rows of a render without
    top-K where the field runs in float32 (``a_dtype``, the line one-hot's
    dtype, None and ``grid_dtype`` float32 or None).  A bf16 one-hot keeps
    twice the points."""
    import torch

    from tensorf_tpu_torch.models.config import VEC_MODE
    from tensorf_tpu_torch.models.tensorf import line_uses_matmul
    from tensorf_tpu_torch.train.step import render_widths

    planes = 0 if model_name == "TensorCP" else 3
    direct = 3 if model_name == "TensorCP" else 6
    float32 = a_dtype is None and grid_dtype in (None, torch.float32)
    k = statics.shade_top_k

    def feature_pass(points, fused):
        if not points:
            return 0
        if not fused:
            return direct
        return planes + sum(not line_uses_matmul(points, grid[v], a_dtype) for v in VEC_MODE)

    return sum(
        feature_pass(b * w, statics.fused)
        + feature_pass(rows, statics.fused and not (float32 and (k is None or k >= w)))
        for b, w, rows in zip(batches, render_widths(statics),
                              appearance_rows(statics, batches, shaded)))


def bf16_launches_per_step(statics, model_name: str, batches, grid_dtype, shaded=None) -> int:
    """The scatter-adds of bf16 rows one train step launches: the fused
    path's plane tables, which TensorVMSplit alone casts to ``grid_dtype``
    (as JAX), three per feature pass with rows (``shaded``: see
    appearance_rows); the lines' footprint tables stay float32."""
    import torch

    if not statics.fused or model_name != "TensorVMSplit" or grid_dtype != torch.bfloat16:
        return 0
    return sum(3 + (3 if rows else 0) for rows in appearance_rows(statics, batches, shaded))


def launches_of_step(state, shaded=None) -> dict:
    """The launches of each kernel that the step the loop's ``state`` takes
    calls for: scatter_add counts both entry points, scatter_add_bf16 the
    bf16 one; ``shaded``: the step's renders' shaded samples
    (``parity.recording_shaded``)."""
    from tensorf_tpu_torch.train.loop import build_statics

    statics, field = build_statics(state), state.field
    batches = state.quotas or [state.cfg.batch_size]
    return {
        "scatter_add": scatter_launches_per_step(statics, state.cfg.model_name, batches,
                                                 state.geometry.grid_size, field.line_a_dtype,
                                                 shaded, field.grid_dtype),
        "scatter_add_bf16": bf16_launches_per_step(statics, state.cfg.model_name, batches,
                                                   field.grid_dtype, shaded),
    }


def drive(torch, name, cfg, scene, kernels, steps, on_step=None):
    """One path through ``reconstruction``: the launch counts set to 0
    just before it and read just after; each kernel must have launched on
    every step, as many times as that step's statics call for (on a path
    whose steps call for none, such as TensorCP's, no time at all)."""
    import numpy as np

    from tensorf_tpu_torch.parallel import parity
    from tensorf_tpu_torch.train.loop import reconstruction

    want = dict.fromkeys(kernels, 0)

    def count(it, state):  # runs after step ``it``, whose statics the state still holds
        for kernel, n in launches_of_step(state, shaded).items():
            want[kernel] += n
        shaded.clear()
        if on_step is not None:
            on_step(it, state)

    for fn, *_ in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with parity.recording_shaded() as shaded:
        result = reconstruction(cfg, scene, "cuda", save_images=False, on_step=count,
                                log=lambda m: print(f"{name}: {m}", flush=True))
    torch.cuda.synchronize()
    launches = {k: v[0].launches for k, v in kernels.items()}
    print(f"{name}: {steps} steps, test-set evaluations and checkpoint in "
          f"{time.perf_counter() - t0:.2f} s, launches {launches} (want {want})", flush=True)
    check(set(want) == set(launches), f"{name}: launch counts {launches}, want {want}")
    for kernel, n in want.items():
        check(launches[kernel] == n, f"{name}: {kernel} launched {launches[kernel]} times "
              f"in {steps} steps, want {n}")
    losses = np.asarray(result.total_loss)
    check(losses.shape == (steps,) and np.all(np.isfinite(losses)), f"{name}: non-finite loss")
    # (a path that scores its final state itself renders no test split here)
    check(len(result.final_psnrs) == (len(result.state.test_ds.all_rays) if cfg.render_test
                                      else 0)
          and np.all(np.isfinite(result.final_psnrs)), f"{name}: non-finite test render")
    print(f"{name}: largest eval overflow by iteration {result.eval_overflow} (stratify_render "
          f"{cfg.stratify_render}; must be 0.0)", flush=True)
    check(all(v == 0.0 for v in result.eval_overflow.values()),
          f"{name}: an evaluation overflowed its sample budget: {result.eval_overflow}")
    return result, launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script needs one NVIDIA GPU")
    try:
        from tensorf_tpu_torch.ops.scatter_add import (KERNEL_NAME, KERNEL_SOURCE, scatter_add,
                                                       scatter_add_bf16)
        from tensorf_tpu_torch.utils.cuda_build import build
    except ImportError as exc:
        fail(f"run from the root of a tensorf_tpu checkout ({exc})")
    import tempfile

    import numpy as np

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # name: (wrapper, source, TPU kernel replaced, grids each call enqueues).
    # Both are entry points of csrc/scatter_add.cu: scatter_add counts every
    # launch, scatter_add_bf16 those of the bf16 entry point (a bf16 g)
    replaces = "tensorf_tpu/ops/pallas/scatter_add2.py:156"
    grids = ["zero_fill_kernel", "scatter_add_runs_kernel"]
    kernels = {KERNEL_NAME: (scatter_add, KERNEL_SOURCE, replaces, grids),
               "scatter_add_bf16": (scatter_add_bf16, KERNEL_SOURCE, replaces, grids)}
    t0 = time.perf_counter()
    # the kernels' library (nvcc, sm_90a) and the host marching library
    # (g++) of mesh export, all at once
    built = build([KERNEL_NAME, "marching"], force=True)
    print(f"build: {len(kernels)} kernel entry points in csrc/scatter_add.cu with nvcc sm_90a "
          f"and the marching library with g++ in {time.perf_counter() - t0:.2f} s", flush=True)
    for res in built.values():
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build[{res.name}]: {line.strip()}", flush=True)
    print("kernels: " + ", ".join(f"{k} (cuda, {v[1]})" for k, v in kernels.items()), flush=True)
    phase_done("build", t0)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")  # the runs' checkpoints
    try:
        run_paths(torch, np, kernels, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def full_path(torch, np, name, cfg, scene, kernels, on_step=None):
    """Drive synth_full's cut schedule through ``drive`` and hold it to the
    checks both synth_full paths share: the loss halves by FIRST_SEGMENT,
    the grids follow the voxel schedule, the final PSNR beats the one at
    FIRST_SEGMENT.  Prints its events, plans and segments."""
    t0 = time.perf_counter()
    result, launches = drive(torch, name, cfg, scene, kernels, cfg.n_iters, on_step)
    check(launches["scatter_add"] > 0, f"{name}: the kernel never launched: {launches}")
    losses = np.asarray(result.total_loss)
    first, last = float(losses[:5].mean()), float(losses[FIRST_SEGMENT - 5:FIRST_SEGMENT].mean())
    print(f"{name}: loss first-5 mean {first:.6f} -> mean of steps {FIRST_SEGMENT - 5}.."
          f"{FIRST_SEGMENT - 1} {last:.6f}; last step {losses[-1]:.6f}", flush=True)
    check(last < 0.5 * first, f"{name}: the training loss did not fall to half its start in "
          f"{FIRST_SEGMENT} steps")
    for e in result.events:
        print(f"{name}: event " + json.dumps(e), flush=True)
    for plan in result.plans:
        print(f"{name}: plan " + json.dumps(plan), flush=True)
    for seg in result.segments:
        print(f"{name}: segment " + json.dumps(seg), flush=True)
    check_schedule(result, cfg)
    psnr_200 = result.test_psnrs[FIRST_SEGMENT]
    psnr_final = float(np.mean(result.final_psnrs))
    print(f"{name}: test_psnr iteration {FIRST_SEGMENT} {psnr_200:.4f} dB, iteration 400 "
          f"{result.test_psnrs.get(400, float('nan')):.4f} dB, final (iteration "
          f"{cfg.n_iters - 1}) {psnr_final:.4f} dB", flush=True)
    check(psnr_final > psnr_200, f"{name}: final test PSNR {psnr_final} does not beat "
          f"{psnr_200} at {FIRST_SEGMENT}")
    phase_done(name, t0)
    return result, launches


def shading_decisions(torch, np, handle, rays):
    """Per ray (a device tensor (B, 6)) of the unbudgeted render under
    ``handle``'s settings: the largest weight that one of its shading
    decisions moves when that decision lies within FLIP_MARGIN of flipping,
    else 0.  The decisions: each top-K weight against the weight threshold,
    and the K-th weight against the (K+1)-th where that one is shaded too."""
    from tensorf_tpu_torch.ops.freq_mask import FreeMasks
    from tensorf_tpu_torch.render.volume import render_rays

    thr, d = handle.field.cfg.ray_march_weight_thres, FLIP_MARGIN
    moved = []
    for s in range(0, rays.shape[0], UNIFORM_CHUNK):
        with torch.no_grad():
            w = render_rays(handle.field, rays[s : s + UNIFORM_CHUNK], FreeMasks(),
                            aabb=handle.aabb, step_size=handle.step_size,
                            n_samples=handle.n_samples, is_train=False, white_bg=handle.white_bg,
                            shade_top_k=handle.shade_top_k, fused=handle.fused,
                            use_coarse_gate=handle.use_coarse_gate, alpha_mask=handle.alpha_mask,
                            u=None).weights
        K = min(handle.shade_top_k or w.shape[1], w.shape[1])
        ws = torch.sort(w, dim=-1, descending=True).values
        top = ws[:, :K]
        near_thr = torch.where((top - thr).abs() <= d * thr, top, torch.zeros_like(top))
        best = near_thr.amax(dim=-1)
        if K < ws.shape[1]:
            wk, wk1 = ws[:, K - 1], ws[:, K]
            at_cut = (wk - wk1 <= d * wk) & (wk1 > (1.0 - d) * thr)
            best = torch.maximum(best, torch.where(at_cut, wk, torch.zeros_like(wk)))
        moved.append(best)
    return torch.cat(moved).cpu().numpy()


def same_render(torch, np, handle, rays, got, want):
    """Hold a render (rgb, depth) of device rays against the unbudgeted one
    under ``handle``'s settings: depth within 1e-4 (+1e-4 relative) on
    every ray; rgb within 1e-5 (+1e-5 relative) on every ray but those
    where a shading decision lies within FLIP_MARGIN of flipping, which may
    differ by up to the weight it moves.  Both renders integrate the same
    samples; their float32 sums associate differently, so a weight on a
    shading decision's edge can fall either way.  Returns (max |d rgb|,
    max |d depth|, rays outside 1e-5 rgb, a failure message or None)."""
    g_rgb, g_depth, w_rgb, w_depth = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (*got, *want))
    d_rgb = np.abs(g_rgb - w_rgb)
    d_depth = np.abs(g_depth - w_depth)
    e_rgb = d_rgb.max(axis=-1)
    out = np.nonzero(np.any(d_rgb > 1e-5 + 1e-5 * np.abs(w_rgb), axis=-1))[0]
    bad_depth = np.nonzero(d_depth > 1e-4 + 1e-4 * np.abs(w_depth))[0]
    msg = None
    if bad_depth.size:
        i = bad_depth[np.argmax(d_depth[bad_depth])]
        msg = (f"{bad_depth.size} rays differ in depth beyond 1e-4, the largest by "
               f"{float(d_depth[i]):.3g} (ray {int(i)})")
    elif out.size:
        moved = shading_decisions(torch, np, handle, rays[torch.as_tensor(out, device=rays.device)])
        unexplained = e_rgb[out] > moved * (1.0 + FLIP_MARGIN) + 1e-5
        if unexplained.any():
            j = np.argmax(np.where(unexplained, e_rgb[out], -1.0))
            msg = (f"{int(unexplained.sum())} of the {out.size} rays outside 1e-5 rgb are no "
                   f"shading flip: ray {int(out[j])} differs by {float(e_rgb[out[j]]):.3g}, its "
                   f"decision within {FLIP_MARGIN} of flipping moves a weight of "
                   f"{float(moved[j]):.3g}")
    return float(e_rgb.max()), float(d_depth.max()), int(out.size), msg


def exactness_phase(torch, np, state):
    """256 real test rays of the final state: each stratum of their own plan
    at its candidate budget and chord lattice, and the rays the eval
    budget covers in "alive" mode at it, against the unbudgeted masked
    render (the JAX package's tolerances: rgb 1e-5, depth 1e-4)."""
    from tensorf_tpu_torch.render.chunked import render_chunked
    from tensorf_tpu_torch.render.culling import (
        _budget_hint,
        count_ray_candidates_and_alive,
        count_ray_candidates_and_chord,
        stratify_rays,
    )
    from tensorf_tpu_torch.train.loop import make_handle

    handle = make_handle(state)
    n, aabb_np = state.n_samples, state.geometry.aabb_np
    count_args = (aabb_np, state.geometry.step_size, state.near_far)
    rays = torch.as_tensor(state.test_ds.all_rays[0][::156][:256], device=state.device)
    kw = dict(chunk=256, step_size=handle.step_size, white_bg=state.white_bg,
              shade_top_k=handle.shade_top_k, fused=True, use_coarse_gate=handle.use_coarse_gate)
    rgb, depth, _, _ = render_chunked(state.field, state.alpha_mask, rays, handle.aabb,
                                      n_samples=n, **kw)
    counts, chords = count_ray_candidates_and_chord(rays, state.alpha_mask, *count_args,
                                                    n_samples=n)
    strata, budgets = stratify_rays(counts)
    worst = [0.0, 0.0]
    for s, (sel, b) in enumerate(zip(strata, budgets)):
        lattice = min(n, _budget_hint(int(chords[sel].max())))
        budget = b if b < n else None
        idx = torch.as_tensor(sel, device=state.device)
        got_rgb, got_depth, _, overflow = render_chunked(
            state.field, state.alpha_mask, rays[idx], handle.aabb, n_samples=lattice,
            sample_budget=budget, budget_mode="cand", **kw)
        e_rgb, e_depth, flips, msg = same_render(torch, np, handle, rays[idx],
                                                 (got_rgb, got_depth), (rgb[idx], depth[idx]))
        print(f"exactness: stratum {s}: {sel.size} rays, counts <= {int(counts[sel].max())}, "
              f"budget {budget}, lattice {lattice} of {n}, overflow {overflow}, max |d rgb| "
              f"{e_rgb:.3g}, max |d depth| {e_depth:.3g}, shading flips {flips}", flush=True)
        check(overflow == 0.0 and msg is None, f"stratum {s} at budget {budget}, lattice "
              f"{lattice} differs from the unbudgeted render (overflow {overflow}; {msg})")
        worst = [max(worst[0], e_rgb), max(worst[1], e_depth)]
    K = handle.sample_budget
    check(K is not None, "the final eval renders with no sample budget")
    cand, alive, _ = count_ray_candidates_and_alive(rays, state.alpha_mask, *count_args,
                                                    n_samples=n)
    covered = np.nonzero((cand <= min(n, K + 224)) & (alive <= K))[0]
    idx = torch.as_tensor(covered, device=state.device)
    got_rgb, got_depth, _, overflow = render_chunked(
        state.field, state.alpha_mask, rays[idx], handle.aabb, n_samples=n, sample_budget=K,
        budget_mode="alive", **kw)
    e_rgb, e_depth, flips, msg = same_render(torch, np, handle, rays[idx], (got_rgb, got_depth),
                                             (rgb[idx], depth[idx]))
    print(f"exactness: {len(strata)} strata of 256 rays (budgets {budgets}) max |d rgb| "
          f"{worst[0]:.3g}, max |d depth| {worst[1]:.3g}; alive mode at budget {K}: "
          f"{covered.size} of 256 rays covered (alive <= {K}, candidates <= {min(n, K + 224)}), "
          f"overflow {overflow}, max |d rgb| {e_rgb:.3g}, max |d depth| {e_depth:.3g}, shading "
          f"flips {flips} (tol rgb 1e-5 but for shading flips, depth 1e-4)", flush=True)
    check(covered.size > 0 and overflow == 0.0 and msg is None,
          f"the alive-mode render at budget {K} differs from the unbudgeted render "
          f"(overflow {overflow}; {msg})")


def reference_phase(torch, np, cfg, scene, result):
    """The masked render at the eval budget against the CPU path; the
    final checkpoint re-rendered through the render-only entry."""
    import copy
    import dataclasses

    from tensorf_tpu_torch.render.chunked import render_chunked
    from tensorf_tpu_torch.train.loop import make_handle, render_test

    state = result.state
    handle = make_handle(state)
    rays = torch.as_tensor(state.test_ds.all_rays[0][::156][:256])
    kw = dict(chunk=256, step_size=handle.step_size, n_samples=handle.n_samples,
              white_bg=True, shade_top_k=handle.shade_top_k, fused=True,
              sample_budget=handle.sample_budget, use_coarse_gate=handle.use_coarse_gate)
    on_card = render_chunked(state.field, state.alpha_mask, rays, handle.aabb, **kw)[0].cpu()
    on_cpu = render_chunked(copy.deepcopy(state.field).cpu(), state.alpha_mask.to("cpu"), rays,
                            handle.aabb.cpu(), **kw)[0]
    diff = (on_card - on_cpu).abs()
    err = float(diff.max())
    # float32 rounds differently on the two devices; a sample whose weight
    # sits at the shading threshold or at the K-th place of the top-K can
    # switch sides and move its pixel by about that weight, hence 1e-3
    print(f"reference: {rays.shape[0]} test rays, masked, budget {handle.sample_budget}, grid "
          f"{state.geometry.grid_size}, |card - cpu| max {err:.3g} mean {float(diff.mean()):.3g} "
          f"(tol 1e-3)", flush=True)
    check(err <= 1e-3, f"card render differs from the CPU reference by {err}")
    psnr_final = float(np.mean(result.final_psnrs))
    reloaded = render_test(dataclasses.replace(cfg, ckpt=result.final_path, render_test=1),
                           scene, "cuda", save_images=False, log=lambda m: None)
    delta = abs(float(np.mean(reloaded)) - psnr_final)
    print(f"render_only: {result.final_path.rsplit('/', 1)[-1]} at budget {cfg.sample_budget}: "
          f"test psnr {float(np.mean(reloaded)):.6f} dB, |delta| {delta:.3g} (tol 1e-4)",
          flush=True)
    check(delta <= 1e-4, f"the final checkpoint renders {np.mean(reloaded)}, not {psnr_final}")


def serving_phase(torch, np, state):
    """One 800x800 view of the final state served through the eval's
    handle, stratified against uniform (same_render, overflow exactly 0.0),
    from device and from host rays; the legacy path, without the coarse
    gate and with the exact-alive stage, on the 200x200 test view; the
    bucket table and ms per frame of both renders."""
    import dataclasses

    from tensorf_tpu_torch.profile_step import SERVE_SCALE, serving_view
    from tensorf_tpu_torch.render.chunked import rays_from_pose, render_chunked_stratified
    from tensorf_tpu_torch.train.loop import make_handle

    handle = make_handle(state)
    check(handle.stratified and handle.use_coarse_gate,
          "the eval handle does not serve stratified from the window bits")
    directions, c2w = serving_view(state.test_ds, SERVE_SCALE, state.device)
    rays = rays_from_pose(directions, c2w)
    M = rays.shape[0]
    lines = []
    rgb, depth, n_valid = handle.render(rays, chunk=SERVE_CHUNK, log=lines.append)
    overflow = handle.max_overflow
    # the unbudgeted uniform render, through the same handle's other path
    flat = dataclasses.replace(handle, stratified=False, sample_budget=None)
    u_rgb, u_depth, u_valid = flat.render(rays, chunk=UNIFORM_CHUNK)
    e_rgb, e_depth, flips, msg = same_render(torch, np, flat, rays, (rgb, depth), (u_rgb, u_depth))
    buckets = {}
    for line in lines[1:]:
        f = dict(kv.split("=") for kv in line.split() if "=" in kv)
        key = (f["tier"], f["K"], int(f["lattice"]))
        rows, chunks = buckets.get(key, (0, []))
        buckets[key] = (rows + int(f["rays"]), chunks + [int(f["chunk"])])
    print(f"serving: {M} rays ({int(np.sqrt(M))}x{int(np.sqrt(M))}, test pose 0, focal x"
          f"{SERVE_SCALE}) of the final state: grid {state.geometry.grid_size}, lattice "
          f"{handle.n_samples}, chunk {SERVE_CHUNK}; {lines[0]}", flush=True)
    for (tier, K, lattice), (rows, chunks) in buckets.items():
        print(f"serving: bucket tier {tier} K {K} lattice {lattice}: {rows} rays in "
              f"{len(chunks)} chunks {sorted(set(chunks))}", flush=True)
    print(f"serving: stratified vs uniform (chunk {UNIFORM_CHUNK}): overflow {overflow}, shaded "
          f"samples {n_valid} vs {u_valid}, max |d rgb| {e_rgb:.3g} (tol 1e-5 but for shading "
          f"flips), max |d depth| {e_depth:.3g} (tol 1e-4), shading flips {flips} (rays outside "
          f"1e-5 rgb, each with a decision within {FLIP_MARGIN} of flipping that moves at least "
          f"its difference)", flush=True)
    check(overflow == 0.0 and flat.max_overflow == 0.0 and msg is None,
          f"the stratified 800x800 frame differs from the uniform render (overflow {overflow}, "
          f"{flat.max_overflow}; {msg})")
    host = handle.render(rays.cpu().numpy(), chunk=SERVE_CHUNK)
    same = (all(np.array_equal(a, b) for a, b in zip(host, (rgb, depth, n_valid)))
            and handle.max_overflow == 0.0)
    print(f"serving: host rays render identically to device rays: {same}", flush=True)
    check(same, "the frame from host rays differs from the frame from device rays")

    view = torch.as_tensor(state.test_ds.all_rays[0].reshape(-1, 6), device=state.device)
    v_rgb, v_depth, _ = flat.render(view, chunk=UNIFORM_CHUNK)
    no_gate = dataclasses.replace(handle, use_coarse_gate=False)
    legacy = {"no coarse gate": (*no_gate.render(view, chunk=SERVE_CHUNK)[:2],
                                 no_gate.max_overflow)}
    kw = dict(step_size=handle.step_size, n_samples=handle.n_samples, white_bg=handle.white_bg,
              shade_top_k=handle.shade_top_k, fused=handle.fused, chunk=SERVE_CHUNK)
    a_rgb, a_depth, _, a_over = render_chunked_stratified(
        handle.field, handle.alpha_mask, view, handle.aabb, alive_stage=True, **kw)
    legacy["exact-alive stage"] = (a_rgb, a_depth, a_over)
    for name, (l_rgb, l_depth, over) in legacy.items():
        e_rgb, e_depth, flips, msg = same_render(torch, np, flat, view, (l_rgb, l_depth),
                                                 (v_rgb, v_depth))
        print(f"serving: legacy path ({name}) on the {view.shape[0]}-ray test view: overflow "
              f"{over}, max |d rgb| {e_rgb:.3g}, max |d depth| {e_depth:.3g}, shading flips "
              f"{flips}", flush=True)
        check(over == 0.0 and msg is None,
              f"the legacy path ({name}) differs from the uniform render (overflow {over}; {msg})")

    strat_ms = time_ms(torch, lambda: handle.render(rays_from_pose(directions, c2w),
                                                    chunk=SERVE_CHUNK), 3)
    uniform_ms = time_ms(torch, lambda: flat.render(rays, chunk=UNIFORM_CHUNK), 1)
    print(f"serving: ms per {M}-ray frame (CUDA events, after a warm frame): stratified "
          f"{strat_ms:.3f}, uniform {uniform_ms:.3f}", flush=True)


def ply_vertices(np, path):
    """The (V, 3) float32 vertices of a binary .ply as eval/mesh.py writes it."""
    with open(path, "rb") as f:
        head, body = f.read().split(b"end_header\n", 1)
    n = int(next(line for line in head.decode().splitlines()
                 if line.startswith("element vertex")).split()[-1])
    return np.frombuffer(body[: n * 12], "<f4").reshape(n, 3)


def mesh_export(torch, np, kernels, name, config, ckpt, min_verts=1):
    """The CLI's mesh export of ``ckpt``: it must write the .ply beside it
    and nothing else, launch no kernel (it takes no train step), run the
    native marching library and write at least ``min_verts`` vertices.
    Returns the CLI's JSON line and the .ply's vertices."""
    import contextlib
    import io
    import os

    from tensorf_tpu_torch import __main__ as cli

    folder = os.path.dirname(ckpt)
    before = set(os.listdir(folder))
    for fn, *_ in kernels.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--config", config, "--export_mesh", "1", "--ckpt", ckpt,
                       "--save_images", "0"])
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        print(f"{name}: {line}", flush=True)
    check(rc == 0, f"{name}: the mesh export exited {rc}")
    row = json.loads(text.strip().splitlines()[-1])
    added = set(os.listdir(folder)) - before
    check(added == {os.path.basename(row["ply"])},
          f"{name}: the mesh export wrote {sorted(added)}, want only the .ply")
    launched = {k: v[0].launches for k, v in kernels.items()}
    check(not any(launched.values()), f"{name}: the mesh export launched kernels {launched}: "
          "it took a train step")
    check(row["native"], f"{name}: the mesh export ran the numpy marching, not the native library")
    verts = ply_vertices(np, row["ply"])
    check(len(verts) == row["verts"] >= min_verts and (row["faces"] > 0 or not min_verts)
          and np.all(np.isfinite(verts)), f"{name}: the .ply holds {len(verts)} vertices, the "
          f"CLI reported {row['verts']}, want at least {min_verts}")
    print(f"{name}: {row['verts']} vertices, {row['faces']} faces, native marching "
          f"{row['native']}; alpha grid {row['alpha_ms']:.1f} ms on the card (host clock, "
          f"synchronised), marching and .ply {row['march_ms']:.1f} ms on the host; export "
          f"{seconds:.2f} s in all", flush=True)
    return row, verts


def resume_snapshot(cfg, dest):
    """An ``on_step`` hook: after step RESUME_KILL it copies the run's
    logfolder (basedir/<date>/<expname>) under ``dest`` as it stands, which
    is what a kill after that step leaves on disk."""
    import glob
    import os

    def hook(it, state):
        if it == RESUME_KILL:
            (folder,) = glob.glob(f"{cfg.basedir}/*/{cfg.expname}")
            date = os.path.basename(os.path.dirname(folder))
            shutil.copytree(folder, f"{dest}/{date}/{cfg.expname}")
            print(f"resume: the logfolder copied after step {RESUME_KILL}", flush=True)
    return hook


def resume_phase(torch, np, cfg, scene, clean_psnr, basedir) -> None:
    """``resume`` of synth_sphere in ``basedir``, the logfolder that
    resume_snapshot copied from the uninterrupted run of ``cfg``, whose
    final test PSNR is ``clean_psnr``."""
    import dataclasses
    import glob
    import os

    from tensorf_tpu_torch.convert import optimizer_to_jax, params_to_jax
    from tensorf_tpu_torch.train.loop import TrainState, reconstruction
    from tensorf_tpu_torch.utils.ckpt import load_opt_leaves

    cfg = dataclasses.replace(cfg, basedir=basedir)
    found = glob.glob(f"{cfg.basedir}/*/{cfg.expname}/0k_{cfg.expname}.npz")
    check(len(found) == 1, f"resume: the uninterrupted run left no copy after step "
          f"{RESUME_KILL} ({found})")
    (ckpt,) = found

    # what a resume loads (the same calls reconstruction makes) equals the
    # checkpoint exactly
    state = TrainState(dataclasses.replace(cfg, resume=1, ckpt_path=ckpt), torch.device("cuda"),
                       scene)
    data = np.load(ckpt)
    leaves = load_opt_leaves(ckpt)
    check(state.start_iter == RESUME_KILL and state.restore_optimizer(leaves, lambda m: None),
          "resume: the checkpoint at 250 does not resume at 251 with its optimizer state")
    same_params = all(np.array_equal(v, data[f"params/{k}"])
                      for k, v in params_to_jax(state.field).items())
    same_opt = all(np.array_equal(a, b)
                   for a, b in zip(optimizer_to_jax(state.optimizer, state.field), leaves))
    print(f"resume: loaded parameters equal the checkpoint's {same_params}, Adam state "
          f"({len(leaves)} leaves, step {int(leaves[0])}) equal {same_opt}", flush=True)
    check(same_params and same_opt, "resume: what the resume loads differs from the checkpoint")
    del state, data

    lines = []

    def log(m):
        lines.append(m)
        print(f"resume: {m}", flush=True)

    resumed = reconstruction(dataclasses.replace(cfg, resume=1), scene, "cuda",
                             save_images=False, log=log)
    for want in (f"continuing at iteration {RESUME_KILL}", "optimizer state restored",
                 "sampling state restored"):
        check(any(want in line for line in lines), f"resume: no '{want}' in the resumed run's log")
    hist = np.load(os.path.join(os.path.dirname(resumed.final_path), "history.npz"))
    rows = [int(i) for i in hist["iteration"]]
    check(250 in rows, f"resume: history.npz rows {rows} lack the row at 250")
    psnr = float(np.mean(resumed.final_psnrs))
    delta = psnr - clean_psnr
    print(f"resume: {len(resumed.total_loss)} steps after the resume; final test psnr resumed "
          f"{psnr:.4f} dB, uninterrupted {clean_psnr:.4f} dB, delta {delta:+.4f} dB (max "
          f"{RESUME_MAX_DPSNR}); history rows {rows}", flush=True)
    check(abs(delta) <= RESUME_MAX_DPSNR, f"resume: the resumed run's test psnr {psnr} is "
          f"{delta:+.3f} dB from the uninterrupted run's {clean_psnr}")


def loss_fall(np, losses, end):
    """(mean of the first 5 losses, mean of the 5 before ``end``)."""
    losses = np.asarray(losses)
    return float(losses[:5].mean()), float(losses[end - 5:end].mean())


def selected_test_split(scene, idxs):
    """The scene with its test split cut to the views ``idxs`` selects, in
    order: what a run's evaluation scores; render-only renders a whole
    split."""
    test = dict(scene["test"], frames=[scene["test"]["frames"][i] for i in idxs])
    return dict(scene, test=test)


def lego_phase(torch, np, kernels, workdir):
    """configs/lego.txt through ``reconstruction`` as written but for the
    cut schedule (profile_step.LEGO_CUT) on Blender's split sizes.
    TensorCP launches no kernel, so its card step is held to the CPU's,
    and its run to 0 scatter-adds, the loss bar, every segment stratified,
    eval overflow 0.0 and a render-only re-render of the final checkpoint;
    then its mesh export.  As written, the config's L1 term holds the CP
    density at its initial plateau on this scene (in both packages; PERF.md
    §6 PR 7), so the same path's first segment runs again with the L1
    weights at 0: its loss must fall to LEGO_L1_OFF_LOSS_RATIO and its test
    view beat the untrained field's.  Returns the launch counts of both."""
    import dataclasses

    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.profile_step import LEGO, LEGO_CUT, PATHS, path_scene
    from tensorf_tpu_torch.train.loop import render_test

    t0 = time.perf_counter()
    cfg = load_config(LEGO, dict(LEGO_CUT, basedir=workdir))
    views, _ = PATHS[LEGO]
    scene = path_scene(LEGO, cfg)
    print(f"cuts: lego_path: {cfg.n_iters} of 3000 steps with upsamples at {cfg.upsamp_list} "
          f"and alpha masks at {cfg.update_AlphaMask_list} (config: [2000..7000], [2000, 4000]; "
          f"the one event in reach, at 2000, moves to {LEGO_FIRST_SEGMENT}), LR decay over "
          f"{cfg.lr_decay_iters}, evaluations at {cfg.vis_every} (2000) and of the final state "
          f"(render_test {cfg.render_test}; the config sets none); the scene has Blender's "
          f"{views['n_train']}/{views['n_test']} views at {views['wh'][0]}x{views['wh'][1]}, "
          f"of which the {len(cfg.train_idxs)} train and {len(cfg.test_idxs)} test views the "
          f"config selects are traced ({time.perf_counter() - t0:.1f} s); {cfg.model_name} "
          f"ranks {cfg.n_lamb_sigma}/{cfg.n_lamb_sh}, app_dim {cfg.data_dim_color}, "
          f"{cfg.shadingMode} shading (pe {cfg.pos_pe}/{cfg.view_pe}/{cfg.fea_pe}, featureC "
          f"{cfg.featureC}), batch {cfg.batch_size}, sample_budget {cfg.sample_budget}, "
          f"downsample {cfg.downsample_train}, L1 {cfg.L1_weight_inital}/{cfg.L1_weight_rest}, "
          f"stratify {cfg.stratify}, stratify_render {cfg.stratify_render} as written", flush=True)
    device_parity_phase(torch, cfg, scene, "lego_parity")
    torch.cuda.empty_cache()

    result, launches = drive(torch, "lego_path", cfg, scene, kernels, cfg.n_iters)
    check(launches["scatter_add"] == 0, f"lego_path: TensorCP launched {launches} scatter-adds")
    check(all(seg["strata"] > 0 for seg in result.segments),
          "lego_path: a segment ran unstratified")
    for e in result.events:
        print("lego_path: event " + json.dumps(e), flush=True)
    for plan in result.plans:
        print("lego_path: plan " + json.dumps(plan), flush=True)
    for seg in result.segments:
        print("lego_path: segment " + json.dumps(seg), flush=True)
    first, last = loss_fall(np, result.total_loss, LEGO_FIRST_SEGMENT)
    psnr_first = result.test_psnrs[min(result.test_psnrs)]
    psnr_final = float(np.mean(result.final_psnrs))
    print(f"lego_path: loss first-5 mean {first:.6f} -> mean of steps "
          f"{LEGO_FIRST_SEGMENT - 5}..{LEGO_FIRST_SEGMENT - 1} {last:.6f} (ratio "
          f"{last / first:.4f}, bar {LEGO_LOSS_RATIO}: the plateau the CPU drive shows); test "
          f"psnr iteration {min(result.test_psnrs)} {psnr_first:.4f} dB, final (iteration "
          f"{cfg.n_iters - 1}) {psnr_final:.4f} dB over the {len(result.final_psnrs)} selected "
          f"test views", flush=True)
    check(last <= LEGO_LOSS_RATIO * first, f"lego_path: the loss rose to {last / first:.4f} of "
          f"its start over the first segment, above the bar {LEGO_LOSS_RATIO}")
    reloaded = render_test(dataclasses.replace(cfg, ckpt=result.final_path, render_test=1),
                           selected_test_split(scene, cfg.test_idxs), "cuda", save_images=False,
                           log=lambda m: None)
    delta = abs(float(np.mean(reloaded)) - psnr_final)
    print(f"render_only: lego_path's final checkpoint, its {len(reloaded)} selected test views: "
          f"test psnr {float(np.mean(reloaded)):.6f} dB, |delta| {delta:.3g} (tol 1e-4)",
          flush=True)
    check(delta <= 1e-4, f"lego_path: the final checkpoint renders {np.mean(reloaded)}, not "
          f"{psnr_final}")
    final_path = result.final_path
    del result
    torch.cuda.empty_cache()
    # a field the alpha mask found empty exports an empty mesh
    mesh_export(torch, np, kernels, "mesh_lego", LEGO, final_path, min_verts=0)

    l1_off = dataclasses.replace(cfg, L1_weight_inital=0.0, L1_weight_rest=0.0)
    res, off_launches, untrained = first_segment(torch, np, "lego_l1_off", l1_off, scene,
                                                 kernels, LEGO_L1_OFF_STEPS)
    first, last = loss_fall(np, res.total_loss, LEGO_L1_OFF_STEPS)
    print(f"lego_l1_off: loss first-5 mean {first:.6f} -> last-5 mean {last:.6f} (ratio "
          f"{last / first:.4f}, bar {LEGO_L1_OFF_LOSS_RATIO}); test view 0 {res.test_psnr:.4f} dB "
          f"against {untrained:.4f} untrained", flush=True)
    check(last <= LEGO_L1_OFF_LOSS_RATIO * first and res.test_psnr > untrained,
          f"lego_l1_off: the loss fell to {last / first:.4f} of its start (bar "
          f"{LEGO_L1_OFF_LOSS_RATIO}), test psnr {res.test_psnr} against {untrained} untrained")
    phase_done("lego_path", t0)
    return launches["scatter_add"], off_launches["scatter_add"]


def first_segment(torch, np, name, cfg, scene, kernels, steps, capture=None):
    """``steps`` first-segment steps of ``cfg``'s path through
    ``train_steps``, the launch counts set to 0 just before and read just
    after (each step's statics say how many it calls for); ``capture(it,
    state)`` runs after each step.  Returns (result, launches, untrained
    test PSNR), the untrained field's PSNR on the same test view."""
    from tensorf_tpu_torch.parallel import parity
    from tensorf_tpu_torch.train.loop import train_steps

    untrained = train_steps(cfg, 0, device="cuda", scene=scene, log=lambda m: None).test_psnr
    want = dict.fromkeys(kernels, 0)

    def count(it, state):
        for kernel, n in launches_of_step(state, shaded).items():
            want[kernel] += n
        shaded.clear()
        if capture is not None:
            capture(it, state)

    for fn, *_ in kernels.values():
        fn.launches = 0
    with parity.recording_shaded() as shaded:
        result = train_steps(cfg, steps, device="cuda", scene=scene, on_step=count,
                             log=lambda m: print(f"{name}: {m}", flush=True))
    torch.cuda.synchronize()
    launches = {k: v[0].launches for k, v in kernels.items()}
    print(f"{name}: {cfg.model_name} {cfg.shadingMode}, {steps} steps at "
          f"{result.grid_size}, {result.step_ms:.3f} ms/step, launches {launches} (want "
          f"{want}); test view 0 psnr {result.test_psnr:.4f} dB (untrained "
          f"{untrained:.4f})", flush=True)
    check(launches == want, f"{name}: launches {launches}, want {want}")
    check(np.all(np.isfinite(result.total_loss)), f"{name}: non-finite loss")
    return result, launches, untrained


def tensorvm_phase(torch, np, kernels, workdir, scene):
    """configs/synth_full.txt with --model_name TensorVM over the main
    path's first segment, at full width: one step's gradients kernel vs
    plain, the per-stratum launch sum, the loss bar; returns the index
    streams its last step hands the kernel and its launch counts."""
    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.profile_step import CUT_SCHEDULE, OVERRIDES

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = load_config("configs/synth_full.txt", dict(OVERRIDES, **CUT_SCHEDULE, basedir=workdir,
                                                     model_name="TensorVM"))
    step_parity_phase(torch, dev, cfg, scene, "tensorvm_parity")
    torch.cuda.empty_cache()
    streams = {}

    def capture(it, state):
        if it == FIRST_SEGMENT - 1:
            # every stratum's render splits density from appearance here
            # (top-64 below each width)
            streams.update(capture_streams(torch, state, "tensorvm_128", 0))

    result, launches, untrained = first_segment(torch, np, "tensorvm", cfg, scene, kernels,
                                                FIRST_SEGMENT, capture)
    check(launches["scatter_add"] > 0, "tensorvm: the kernel never launched")
    first, last = loss_fall(np, result.total_loss, FIRST_SEGMENT)
    print(f"tensorvm: planes of {cfg.n_lamb_sh[0] + cfg.n_lamb_sigma[0]} channels; loss first-5 "
          f"mean {first:.6f} -> mean of steps {FIRST_SEGMENT - 5}..{FIRST_SEGMENT - 1} "
          f"{last:.6f} (ratio {last / first:.4f}, bar {TENSORVM_LOSS_RATIO}); streams "
          f"{sorted(streams)}", flush=True)
    check(last <= TENSORVM_LOSS_RATIO * first, f"tensorvm: the loss fell to {last / first:.4f} "
          f"of its start, above the bar {TENSORVM_LOSS_RATIO}")
    phase_done("tensorvm", t0)
    return streams, launches


def shading_phase(torch, np, kernels, workdir, scene):
    """Each shading mode of SHADING_MODES on configs/synth_sphere.txt's
    first segment: one step's gradients kernel vs plain, the launch sum, a
    falling loss, and a test PSNR above the untrained field's.  Returns the
    launch counts by mode."""
    from tensorf_tpu_torch.config import load_config

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    out = {}
    for mode, dim in SHADING_MODES.items():
        over = dict(basedir=workdir, shadingMode=mode)
        if dim is not None:
            over["data_dim_color"] = dim
        cfg = load_config("configs/synth_sphere.txt", over)
        step_parity_phase(torch, dev, cfg, scene, f"shading_{mode}_parity")
        result, launches, untrained = first_segment(torch, np, f"shading_{mode}", cfg, scene,
                                                    kernels, SHADING_STEPS)
        check(launches["scatter_add"] > 0, f"shading_{mode}: the kernel never launched")
        first, last = loss_fall(np, result.total_loss, SHADING_STEPS)
        print(f"shading_{mode}: app_dim {cfg.data_dim_color}; loss first-5 mean {first:.6f} -> "
              f"last-5 mean {last:.6f}; test psnr {result.test_psnr:.4f} dB against "
              f"{untrained:.4f} untrained", flush=True)
        check(last < first, f"shading_{mode}: the loss did not fall")
        check(result.test_psnr > untrained, f"shading_{mode}: test psnr {result.test_psnr} does "
              f"not beat the untrained field's {untrained}")
        out[mode] = launches["scatter_add"]
        torch.cuda.empty_cache()
    phase_done("shading", t0)
    return out


def line_impls(grid, points):
    """Which implementation samples each of the three lines (VEC_MODE
    order) at ``points`` points: "matmul" (the one-hot) or "footprint"."""
    from tensorf_tpu_torch.models.config import VEC_MODE
    from tensorf_tpu_torch.models.tensorf import line_uses_matmul

    return ["matmul" if line_uses_matmul(points, grid[v]) else "footprint" for v in VEC_MODE]


def flower_phase(torch, np, kernels, workdir):
    """configs/flower.txt (NDC rays, LLFF) through its phases: flower_parity
    (one first-segment step kernel vs plain and card vs CPU), flower_path
    (``reconstruction`` as written but for FLOWER_CUT, on the forward-facing
    capture: every segment up to n_to_reso(640^3) at batch 4096, the loss
    bar), flower_serving (the test views served uniform through the eval's
    handle with ms per frame, their PSNR over the untrained field's and
    FLOWER_MIN_PSNR, FLOWER_SPIRAL spiral poses, render-only of the final
    checkpoint within 1e-4 dB) and the kernel against its plain version on
    the last segment's plane and line footprint streams.  Returns (launches
    of the path, kernel case rows)."""
    import dataclasses

    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.eval.evaluation import evaluation_path
    from tensorf_tpu_torch.eval.metrics import psnr
    from tensorf_tpu_torch.profile_step import FLOWER, FLOWER_CUT, PATHS, path_scene
    from tensorf_tpu_torch.train.loop import make_handle, render_test, train_steps

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    # the final renders move to flower_serving, which times them
    cfg = load_config(FLOWER, dict(FLOWER_CUT, basedir=workdir, render_test=0))
    scene = path_scene(FLOWER, cfg)
    views = PATHS[FLOWER][0]
    print(f"cuts: flower_path: {cfg.n_iters} of 25000 steps with upsamples at {cfg.upsamp_list} "
          f"and the alpha mask at {cfg.update_AlphaMask_list} (config: [2000, 3000, 4000, "
          f"5500], [2500]), LR decay over {cfg.lr_decay_iters}, render_test {cfg.render_test} "
          f"and render_path {cfg.render_path} (config 1, 1: flower_serving renders the test "
          f"views through the eval's handle and {FLOWER_SPIRAL} spiral poses of 120); "
          f"the forward-facing capture has {views['n_views']} views at {views['wh'][0]}x"
          f"{views['wh'][1]} (flower's images_4; traced in {time.perf_counter() - t0:.1f} s); "
          f"{cfg.model_name} ranks {cfg.n_lamb_sigma}/{cfg.n_lamb_sh}, app_dim "
          f"{cfg.data_dim_color}, {cfg.shadingMode}, batch {cfg.batch_size}, ndc_ray "
          f"{cfg.ndc_ray}, N_voxel {cfg.N_voxel_init} -> {cfg.N_voxel_final} as written",
          flush=True)
    step_parity_phase(torch, dev, cfg, scene, "flower_parity")
    torch.cuda.empty_cache()
    device_parity_phase(torch, cfg, scene, "flower_card_vs_cpu")
    torch.cuda.empty_cache()
    phase_done("flower_parity", t0)

    t0 = time.perf_counter()
    untrained = train_steps(cfg, 0, device="cuda", scene=scene, log=lambda m: None).test_psnr
    torch.cuda.empty_cache()
    result, launches = drive(torch, "flower_path", cfg, scene, kernels, cfg.n_iters)
    check(launches["scatter_add"] > 0, "flower_path: the kernel never launched")
    check(not any(seg["strata"] for seg in result.segments),
          "flower_path: NDC rays ran stratified")
    for e in result.events:
        print("flower_path: event " + json.dumps(e), flush=True)
    for seg in result.segments:
        print(f"flower_path: segment {seg['start']}..{seg['end']}: grid {seg['grid']}, n_samples "
              f"{seg['n_samples']}, samples/step {seg['samples_per_step']}, lines (density pass) "
              f"{line_impls(seg['grid'], seg['samples_per_step'])}, masked {seg['masked']}, "
              f"{seg['ms_per_step']:.3f} ms/step, peak {seg['peak_gib']:.2f} GiB", flush=True)
    check(len(result.segments) == 6, f"flower_path: {len(result.segments)} segments, want 6")
    final = result.segments[-1]
    check(line_impls(final["grid"], final["samples_per_step"]) == ["footprint"] * 3,
          "flower_path: the last segment's lines did not take the footprint gather")
    first, last = loss_fall(np, result.total_loss, FLOWER_FIRST_SEGMENT)
    print(f"flower_path: loss first-5 mean {first:.6f} -> mean of steps "
          f"{FLOWER_FIRST_SEGMENT - 5}..{FLOWER_FIRST_SEGMENT - 1} {last:.6f} (ratio "
          f"{last / first:.4f}, bar {FLOWER_LOSS_RATIO})", flush=True)
    check(last <= FLOWER_LOSS_RATIO * first, f"flower_path: the loss fell to {last / first:.4f} "
          f"of its start, above the bar {FLOWER_LOSS_RATIO}")
    phase_done("flower_path", t0)

    t0 = time.perf_counter()
    state = result.state
    # served on the lattice render-only builds from a checkpoint, the
    # geometry's diag / step + 1 samples, as both packages' render-only
    # entries do; the run itself samples cal_n_samples(grid), which for NDC
    # rays moves every sample (ROADMAP queue 3 item 7), so this is the
    # lattice on which render-only can reproduce the PSNR exactly
    lattice = min(int(cfg.nSamples), state.geometry.n_samples)
    handle = dataclasses.replace(make_handle(state), n_samples=lattice)
    check(handle.ndc_ray and not handle.stratified, "flower: the eval handle does not serve NDC "
          "rays uniform")
    test_ds = state.test_ds
    W, H = test_ds.img_wh
    # render-only scores every test view; the eval's handle serves
    # FLOWER_SERVED of them, timed, which must read render-only's PSNRs
    reloaded = render_test(dataclasses.replace(cfg, ckpt=result.final_path, render_test=1),
                           scene, "cuda", save_images=False, log=lambda m: None)
    psnr_final = float(np.mean(reloaded))
    frame_ms, served = [], []
    for k in range(FLOWER_SERVED):
        rays = torch.as_tensor(test_ds.all_rays[k].reshape(-1, 6), device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rgb, _, _ = handle.render(rays)  # host arrays: the frame is done
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        served.append(psnr(np.clip(rgb, 0, 1), test_ds.all_rgbs[k].reshape(-1, 3)))
    print(f"flower_serving: {len(frame_ms)} of {len(reloaded)} test views of {W}x{H} served "
          f"uniform (lattice {handle.n_samples}, the run's {state.n_samples}; chunk 8192): ms per "
          f"frame {[round(m, 1) for m in frame_ms]}, psnr {[round(p, 4) for p in served]}; final "
          f"test psnr (render-only, every view) {psnr_final:.4f} dB (bar {FLOWER_MIN_PSNR}), "
          f"view 0 against {untrained:.4f} untrained", flush=True)
    check(served[0] > untrained and psnr_final >= FLOWER_MIN_PSNR,
          f"flower: final test psnr {psnr_final} (view 0 {served[0]}, untrained {untrained}), "
          f"bar {FLOWER_MIN_PSNR}")
    poses = test_ds.render_path[:: 120 // FLOWER_SPIRAL][:FLOWER_SPIRAL]
    t1 = time.perf_counter()
    evaluation_path(test_ds, handle, poses)
    print(f"flower_serving: spiral poses {list(range(0, 120, 120 // FLOWER_SPIRAL))} of 120 in "
          f"{(time.perf_counter() - t1) * 1e3 / len(poses):.1f} ms per frame", flush=True)
    delta = max(abs(float(a) - b) for a, b in zip(reloaded, served))
    print(f"render_only: flower_path's final checkpoint: test psnr {psnr_final:.6f} dB, "
          f"|delta| {delta:.3g} (tol 1e-4) against the served views on its lattice", flush=True)
    check(delta <= 1e-4, f"flower: the final checkpoint renders {reloaded[:FLOWER_SERVED]}, not "
          f"{served}")
    del handle
    phase_done("flower_serving", t0)

    t0 = time.perf_counter()
    streams = capture_streams(torch, state, "flower_640", kinds=FLOWER_STREAMS)
    del result, state
    torch.cuda.empty_cache()
    cases = [kernel_case(torch, name, *stream) for name, stream in streams.items()]
    check({c["C"] for c in cases} == set(FLOWER_STREAMS), f"flower streams {sorted(streams)}")
    phase_done("flower_streams", t0)
    return launches["scatter_add"], cases


def write_reference_th(torch, np, path, field, aabb, alpha_mask=None) -> None:
    """Write ``field`` (with ``aabb`` and its alpha mask) as the reference
    saves a model (models/tensorBase.py:160-168): ``torch.save`` of its
    get_kwargs dict, its state dict (planes (1, R, H, W), lines (1, R, L,
    1), ``basis_mat.weight`` (out, in), ``renderModule.mlp.{0,2,4}``; the
    legacy TensorVM's stacked ``plane_coef``/``line_coef``) and the
    bit-packed mask.  Neither package has an exporter; this is the
    th_import check's own writer."""
    cfg = field.cfg
    p = {n: v.detach().cpu() for n, v in field.named_parameters()}

    def plane(x):  # (H, W, R) -> (1, R, H, W)
        return x.permute(2, 0, 1)[None].contiguous()

    def line(x):  # (L, R) -> (1, R, L, 1)
        return x.T[None, :, :, None].contiguous()

    sd = {}
    if cfg.model_name == "TensorVM":
        den, app = cfg.density_n_comp[0], cfg.app_n_comp[0]
        sd["plane_coef"] = torch.stack([p[f"plane.{i}"].permute(2, 0, 1) for i in range(3)])
        sd["line_coef"] = torch.stack([p[f"line.{i}"].T[:, :, None] for i in range(3)])
    else:
        den, app = list(cfg.density_n_comp), list(cfg.app_n_comp)
        for name in ("density", "app"):
            for i in range(3):
                if cfg.model_name == "TensorVMSplit":
                    sd[f"{name}_plane.{i}"] = plane(p[f"{name}_plane.{i}"])
                sd[f"{name}_line.{i}"] = line(p[f"{name}_line.{i}"])
    sd["basis_mat.weight"] = p["basis"].T.contiguous()
    for slot, layer in ((0, "l1"), (2, "l2"), (4, "l3")):
        if f"render.{layer}.w" in p:
            sd[f"renderModule.mlp.{slot}.weight"] = p[f"render.{layer}.w"].T.contiguous()
            sd[f"renderModule.mlp.{slot}.bias"] = p[f"render.{layer}.b"].clone()
    kwargs = {
        "aabb": torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3)),
        "gridSize": [int(g) for g in field.grid_size], "density_n_comp": den,
        "appearance_n_comp": app, "app_dim": cfg.app_dim, "density_shift": cfg.density_shift,
        "alphaMask_thres": cfg.alpha_mask_thres, "distance_scale": cfg.distance_scale,
        "rayMarch_weight_thres": cfg.ray_march_weight_thres, "fea2denseAct": cfg.fea2dense_act,
        "near_far": [float(v) for v in cfg.near_far], "step_ratio": cfg.step_ratio,
        "shadingMode": cfg.shading_mode, "pos_pe": cfg.pos_pe, "view_pe": cfg.view_pe,
        "fea_pe": cfg.fea_pe, "featureC": cfg.feature_c,
    }
    ckpt = {"kwargs": kwargs, "state_dict": sd}
    if alpha_mask is not None:
        vol = alpha_mask.volume.detach().cpu().numpy() > 0.5
        ckpt["alphaMask.shape"] = (1, 1, *vol.shape)
        ckpt["alphaMask.mask"] = np.packbits(vol.reshape(-1))
        ckpt["alphaMask.aabb"] = alpha_mask.aabb.detach().cpu()
    torch.save(ckpt, path)


def cli_line(argv):
    """Run the port's CLI on ``argv`` with its stdout captured; returns
    (exit code, its last JSON line)."""
    import contextlib
    import io

    from tensorf_tpu_torch import __main__ as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def th_import_phase(torch, np, kernels, workdir, config, scene_kw, npz_path, npz_verts) -> None:
    """A path's final field (``config``'s, on the in-memory scene
    ``scene_kw``) written in the reference's ``.th`` layout: render-only of
    it through the CLI reads the PSNR of the ``.npz``'s render-only within
    1e-4 dB, and its mesh export writes as many vertices as the
    ``.npz``'s."""
    import os

    from tensorf_tpu_torch.utils.ckpt import load_checkpoint

    t0 = time.perf_counter()
    folder = os.path.join(workdir, "th_import")
    os.makedirs(folder)
    _, field, aabb, grid, mask, _ = load_checkpoint(npz_path, "cuda")
    th = os.path.join(folder, os.path.basename(npz_path)[: -len(".npz")] + ".th")
    write_reference_th(torch, np, th, field, aabb, mask)
    del field, mask
    print(f"th_import: {os.path.basename(npz_path)} (grid {grid}) written in the reference's "
          f".th layout, {os.path.getsize(th) / 2**20:.1f} MiB", flush=True)
    psnrs = {}
    for tag, ckpt in (("npz", npz_path), ("th", th)):
        rc, row = cli_line(["--config", config, "--render_only", "1", "--render_test", "1",
                            "--ckpt", ckpt, "--synthetic", "--synthetic_scene",
                            scene_kw["scene"], "--synthetic_wh", str(scene_kw["wh"][0]),
                            "--synthetic_views", f"{scene_kw['n_train']},{scene_kw['n_test']}",
                            "--save_images", "0", "--basedir", folder])
        check(rc == 0 and row is not None, f"th_import: render-only of the {tag} exited {rc}")
        psnrs[tag] = float(row["test_psnr"])
    delta = abs(psnrs["th"] - psnrs["npz"])
    print(f"th_import: CLI render-only test psnr from the .th {psnrs['th']:.6f} dB, from the "
          f".npz {psnrs['npz']:.6f} dB, |delta| {delta:.3g} (tol 1e-4)", flush=True)
    check(delta <= 1e-4, f"th_import: the .th renders {psnrs['th']}, the .npz {psnrs['npz']}")
    row, _ = mesh_export(torch, np, kernels, "th_mesh", config, th)
    check(row["verts"] == npz_verts, f"th_import: the .th's mesh has {row['verts']} vertices, "
          f"the .npz's {npz_verts}")
    print(f"th_import: mesh export of the .th: {row['verts']} vertices, as the .npz's",
          flush=True)
    phase_done("th_import", t0)


def bf16_render_phase(torch, np, state) -> None:
    """The main path's final state rendered with every dtype option at
    bfloat16 against its float32 render, on the reference phase's 256 test
    rays at the eval budget: within BF16_RENDER_BAR, JAX's bar for a bf16
    grid (tests/test_render.py)."""
    from tensorf_tpu_torch.render.chunked import render_chunked
    from tensorf_tpu_torch.train.loop import make_handle

    handle = make_handle(state)
    rays = torch.as_tensor(state.test_ds.all_rays[0][::156][:256])
    kw = dict(chunk=256, step_size=handle.step_size, n_samples=handle.n_samples,
              white_bg=True, shade_top_k=handle.shade_top_k, fused=True,
              sample_budget=handle.sample_budget, use_coarse_gate=handle.use_coarse_gate)
    field = state.field
    f32 = render_chunked(field, state.alpha_mask, rays, handle.aabb, **kw)[0].cpu()
    cfg = field.cfg
    field.cfg = cfg.replace(**{k: "bfloat16" for k in ("grid_dtype", "line_dtype", "dtype")})
    try:
        bf16 = render_chunked(field, state.alpha_mask, rays, handle.aabb, **kw)[0].cpu()
    finally:
        field.cfg = cfg
    diff = (bf16 - f32).abs()
    print(f"bf16_render: {rays.shape[0]} test rays of the main path's final state, every dtype "
          f"bfloat16 against float32: |rgb diff| max {float(diff.max()):.4g} mean "
          f"{float(diff.mean()):.4g} (bar {BF16_RENDER_BAR})", flush=True)
    check(float(diff.max()) < BF16_RENDER_BAR, f"bf16_render: the bf16 render differs from the "
          f"float32 one by {float(diff.max())}")


def bf16_phase(torch, np, kernels, workdir, scene):
    """configs/synth_full.txt as written (stratified, full width) with
    grid_dtype, line_dtype and compute_dtype bfloat16 (profile_step.BF16)
    over the main path's first segment: one step's gradients kernel vs
    plain, launches of both entry points equal to the per-stratum sums, the
    main path's loss bar, each segment's ms/step and peak GiB; then the
    bf16 entry point against its plain version on the density and
    appearance streams of the last step's largest stratum, beside the
    float32 entry point on the same streams widened.  Returns (launches,
    kernel case rows)."""
    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.profile_step import BF16, CUT_SCHEDULE, OVERRIDES
    from tensorf_tpu_torch.train.loop import build_statics
    from tensorf_tpu_torch.train.step import render_widths

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = load_config("configs/synth_full.txt", {**OVERRIDES, **CUT_SCHEDULE, **BF16,
                                                 "n_iters": BF16_STEPS, "basedir": workdir})
    print(f"cuts: bf16_path: the main path's first {cfg.n_iters} steps (128^3, no event), "
          f"grid_dtype {cfg.grid_dtype}, line_dtype {cfg.line_dtype}, compute_dtype "
          f"{cfg.compute_dtype}; otherwise as the main path", flush=True)
    # bf16 rounding of the summed plane rows: a sum within float32
    # rounding of its plain twin may round to the next bf16 value, and the
    # footprint's fold adds four such terms in bf16
    step_parity_phase(torch, dev, cfg, scene, "bf16_parity", rel=2.0 ** -6)
    torch.cuda.empty_cache()
    phase_done("bf16_parity", t0)

    t0 = time.perf_counter()
    streams = {}

    def capture(it, state):
        if it == cfg.n_iters - 1:
            rows = [q * w for q, w in zip(state.quotas, render_widths(build_statics(state)))]
            streams.update(capture_streams(torch, state, "bf16_128", int(np.argmax(rows))))

    result, launches = drive(torch, "bf16_path", cfg, scene, kernels, cfg.n_iters, capture)
    check(launches["scatter_add_bf16"] > 0, f"bf16_path: the bf16 entry point never launched: "
          f"{launches}")
    check(all(seg["strata"] > 0 for seg in result.segments), "bf16_path: a segment ran "
          "unstratified")
    for seg in result.segments:
        print("bf16_path: segment " + json.dumps(seg), flush=True)
    first, last = loss_fall(np, result.total_loss, FIRST_SEGMENT)
    psnr = float(np.mean(result.final_psnrs))
    print(f"bf16_path: loss first-5 mean {first:.6f} -> mean of steps {FIRST_SEGMENT - 5}.."
          f"{FIRST_SEGMENT - 1} {last:.6f} (ratio {last / first:.4f}, bar 0.5); test psnr at "
          f"{cfg.n_iters} {psnr:.4f} dB", flush=True)
    check(last < 0.5 * first, f"bf16_path: the training loss did not fall to half its start in "
          f"{FIRST_SEGMENT} steps")
    del result
    torch.cuda.empty_cache()
    phase_done("bf16_path", t0)

    t0 = time.perf_counter()
    cases = []
    for name, (idx, g, n_rows) in streams.items():
        check(g.dtype == torch.bfloat16, f"bf16_path: the {name} stream carries {g.dtype}")
        cases.append(kernel_case(torch, name, idx, g, n_rows))
        cases.append(kernel_case(torch, f"{name}_as_f32", idx, g.float(), n_rows))
    del streams
    torch.cuda.empty_cache()
    phase_done("bf16_streams", t0)
    return launches, cases


def write_lpips_weights(np, folder, net, arch) -> None:
    """Seeded random weights of one LPIPS net in the .npz layout both
    packages read (conv{i}.w HWIO, conv{i}.b, lin{k}.w)."""
    import os

    rng = np.random.default_rng(0)
    out, in_ch = {}, 3
    for i, (out_ch, k, _, _) in enumerate(arch["convs"]):
        out[f"conv{i}.w"] = (rng.standard_normal((k, k, in_ch, out_ch))
                             * np.sqrt(2.0 / (k * k * in_ch))).astype(np.float32)
        out[f"conv{i}.b"] = (0.01 * rng.standard_normal(out_ch)).astype(np.float32)
        in_ch = out_ch
    for t, ci in enumerate(arch["taps"]):
        out[f"lin{t}.w"] = rng.uniform(0, 1, size=arch["convs"][ci][0]).astype(np.float32)
    np.savez(os.path.join(folder, f"lpips_{net}.npz"), **out)


def lpips_phase(torch, np, workdir, image) -> None:
    """AlexNet and VGG LPIPS (eval/lpips.py) with seeded random weights
    from a temporary TENSORF_LPIPS_DIR, on an 800x800 view against a
    perturbed copy: the card against the CPU within LPIPS_RTOL, with the
    card's ms per call."""
    import os

    from tensorf_tpu_torch.eval import lpips

    t0 = time.perf_counter()
    folder = os.path.join(workdir, "lpips")
    os.makedirs(folder)
    for net, arch in lpips.ARCHS.items():
        write_lpips_weights(np, folder, net, arch)
    os.environ["TENSORF_LPIPS_DIR"] = folder
    lpips.clear_cache()
    a = np.ascontiguousarray(image, np.float32)
    b = np.clip(a + 0.05 * np.random.default_rng(1).standard_normal(a.shape), 0, 1).astype(
        np.float32)
    for net in lpips.ARCHS:
        card = lpips.lpips(a, b, net, device="cuda")
        host = lpips.lpips(a, b, net, device="cpu")
        ms = time_ms(torch, lambda: lpips.lpips(a, b, net, device="cuda"), 5)
        rel = abs(card - host) / abs(host)
        print(f"lpips: {net} on a {a.shape[1]}x{a.shape[0]} view: card {card:.7f}, cpu "
              f"{host:.7f}, relative difference {rel:.3g} (tol {LPIPS_RTOL}); {ms:.2f} ms a "
              f"call on the card (host to device copy of both images included)", flush=True)
        check(np.isfinite(card) and card > 0 and rel <= LPIPS_RTOL,
              f"lpips {net}: card {card}, cpu {host}")
    del os.environ["TENSORF_LPIPS_DIR"]
    lpips.clear_cache()
    phase_done("lpips", t0)


def sphere_seed_mean(np, psnrs) -> float:
    """The mean test PSNR of synth_sphere's runs over the seeds, held to
    SPHERE_MIN_PSNR: a single run's PSNR spreads across that bar from seed
    to seed and from card to card, the mean over seed_spread.SEEDS is what the
    JAX package's drive meets (ROADMAP queue 3 item 6)."""
    mean = float(np.mean(list(psnrs.values())))
    print(f"sphere_path: test psnr by seed {json.dumps(psnrs)}; mean {mean:.4f} dB over "
          f"{len(psnrs)} seeds (min {SPHERE_MIN_PSNR}; the CPU drives' means over the same "
          f"seeds: JAX {SPHERE_JAX_MEAN}, the port {SPHERE_PORT_CPU_MEAN})", flush=True)
    check(mean >= SPHERE_MIN_PSNR, f"synth_sphere's mean test psnr over seeds {sorted(psnrs)} "
          f"is {mean}, under {SPHERE_MIN_PSNR}")
    return mean


def dp_step_case(torch, np, cfg, scene):
    """One main-path step's inputs at full width: the 128^3 field drawn
    from the config's seed, its first plan's statics and global ids, the
    store, an Adam state in progress, the noise seed of iteration 0."""
    from tensorf_tpu_torch.parallel import parity
    from tensorf_tpu_torch.train.loop import TrainState, build_statics, restratify, step_seed

    state = TrainState(cfg, torch.device("cuda"), scene)
    restratify(state, 0, lambda m: None)
    case = dict(model_cfg=state.field.cfg, grid=tuple(state.geometry.grid_size),
                params={k: v.cpu().numpy() for k, v in state.field.state_dict().items()},
                aabb=state.geometry.aabb_np.astype(np.float32), mask=None,
                statics=build_statics(state), lr=(cfg.lr_init, cfg.lr_basis, state.lr_factor),
                opt_leaves=parity.adam_in_progress(state.field),
                rays=state.rays.cpu().numpy(), rgbs=state.rgbs.cpu().numpy(),
                ids=tuple(i.numpy() for i in state.sampler.nextids()), step=0,
                seed=step_seed(cfg.seed, 0))
    del state
    torch.cuda.empty_cache()
    return case


def dp_step_parity_phase(torch, np, cfg, scene) -> None:
    """dp_step_parity: one synth_full step at full width on DP_RANKS gloo
    ranks sharing cuda:0 against the same step on one rank: the same global
    batch and noise, an Adam state in progress (parity.adam_in_progress),
    the parameters after it within rel 1e-5 / abs 1e-6 and bit-identical on
    the ranks; the kernel launched on every rank as often as on one, each
    time on its 1/DP_RANKS of the rows."""
    from tensorf_tpu_torch.parallel import parity, spawn

    t0 = time.perf_counter()
    case = dp_step_case(torch, np, cfg, scene)
    want = parity.one_step(None, "cuda:0", case)
    got = spawn(parity.one_step, (case,), ["cuda:0"] * DP_RANKS, timeout_s=DP_TIMEOUT_S,
                collective_timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    worst = 0.0
    for r, res in enumerate(got):
        for k, v in want["params"].items():
            err = np.abs(res["params"][k] - v) - 1e-5 * np.abs(v)
            worst = max(worst, float(np.abs(res["params"][k] - v).max()))
            check(bool(np.all(err <= 1e-6)), f"dp_step_parity: rank {r}'s {k} after the step "
                  f"differs from one rank's by {float(err.max()) + 1e-6} beyond rel 1e-5")
        check(res["launches"] == want["launches"] > 0 and len(res["rows"]) == len(want["rows"]),
              f"dp_step_parity: rank {r} launched the kernel {res['launches']} times, one rank "
              f"{want['launches']}")
        check(sum(res["rows"]) * DP_RANKS == sum(want["rows"]),
              f"dp_step_parity: rank {r} scattered {sum(res['rows'])} rows, one rank "
              f"{sum(want['rows'])}")
        check(abs(res["metrics"]["mse"] - want["metrics"]["mse"]) <= 1e-5 * want["metrics"]["mse"],
              f"dp_step_parity: rank {r}'s mse {res['metrics']['mse']}, one rank's "
              f"{want['metrics']['mse']}")
    check(len({res["checksum"] for res in got}) == 1,
          f"dp_step_parity: the ranks' parameters differ after the all-reduce: "
          f"{[res['checksum'] for res in got]}")
    print(f"dp_step_parity: {DP_RANKS} gloo ranks on cuda:0 vs one rank, synth_full's first step "
          f"at full width (quotas {[len(i) for i in case['ids']]}): max |delta param| {worst:.3g}, "
          f"mse {got[0]['metrics']['mse']:.8f} vs {want['metrics']['mse']:.8f}; kernel launches "
          f"per rank {[res['launches'] for res in got]} (one rank {want['launches']}), rows per "
          f"rank {[sum(res['rows']) for res in got]} (one rank {sum(want['rows'])})", flush=True)
    phase_done("dp_step_parity", t0)


def dp_path_phase(torch, np, cfg, scene, main_psnr):
    """dp_path: ``reconstruction`` of the main path's config on DP_RANKS
    gloo ranks sharing cuda:0 (parallel/parity.py::reconstruct): every plan
    and event line and a parameter checksum after every event equal on the
    ranks, every eval's overflow 0.0, each rank's kernel launches equal to
    the per-stratum sum of its shares, the final PSNR within DP_MAX_DPSNR
    of the main path's.  Prints each rank's ms/step and peak GiB per
    segment (two processes time-slicing one card: no model of two cards).
    Returns each rank's launches."""
    from tensorf_tpu_torch.parallel import parity, spawn

    t0 = time.perf_counter()
    got = spawn(parity.reconstruct, (cfg, scene), ["cuda:0"] * DP_RANKS,
                timeout_s=DP_TIMEOUT_S, collective_timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    print(f"dp_path: {DP_RANKS} gloo ranks on cuda:0, {cfg.n_iters} steps in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def plan_lines(res):
        return [m for m in res["lines"]
                if "stratified ray store" in m or "'event'" in m or "[budget]" in m]

    for line in plan_lines(got[0]):
        print(f"dp_path: {line}", flush=True)
    launches = []
    for r, res in enumerate(got):
        check(plan_lines(res) == plan_lines(got[0]),
              f"dp_path: rank {r}'s plan and event lines differ from rank 0's")
        check(res["checksums"] == got[0]["checksums"]
              and res["final_checksum"] == got[0]["final_checksum"],
              f"dp_path: rank {r}'s parameter checksums {res['checksums']} differ from rank 0's "
              f"{got[0]['checksums']}")
        want = sum(n * scatter_launches_per_step(statics, cfg.model_name, batches, grid, a_dtype,
                                                 shaded, grid_dtype)
                   for statics, batches, grid, a_dtype, grid_dtype, shaded, n in res["steps"])
        n_launch = res["launches"]["scatter_add"]
        check(n_launch == want > 0, f"dp_path: rank {r} launched the kernel {n_launch} times, "
              f"the per-stratum sum of its shares is {want}")
        launches.append(n_launch)
        result = res["result"]
        check(all(v == 0.0 for v in result.eval_overflow.values()),
              f"dp_path: rank {r}'s evaluations overflowed: {result.eval_overflow}")
        check(all(seg["strata"] > 0 for seg in result.segments),
              f"dp_path: a segment of rank {r} ran unstratified")
        for seg in result.segments:
            print(f"dp_path: rank {r} segment {seg['start']}..{seg['end']}: grid {seg['grid']}, "
                  f"quotas {seg['quotas']}, {seg['ms_per_step']:.3f} ms/step, peak "
                  f"{seg['peak_gib']:.2f} GiB", flush=True)
    psnrs = [float(np.mean(res["result"].final_psnrs)) for res in got]
    check(len(set(psnrs)) == 1, f"dp_path: the ranks' final test PSNRs differ: {psnrs}")
    print(f"dp_path: checksums equal on the ranks after every event "
          f"({sorted(got[0]['checksums'])}); kernel launches per rank {launches}; eval overflow "
          f"{got[0]['result'].eval_overflow}; final test psnr {psnrs[0]:.4f} dB, the main path's "
          f"{main_psnr:.4f} (within {DP_MAX_DPSNR})", flush=True)
    check(abs(psnrs[0] - main_psnr) <= DP_MAX_DPSNR,
          f"dp_path: final test PSNR {psnrs[0]} is not within {DP_MAX_DPSNR} dB of the main "
          f"path's {main_psnr}")
    phase_done("dp_path", t0)
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_cli(np, argv, env, label, ranks, timeout):
    """The port's CLI in a child process: checks its exit code and that each
    of ``ranks`` ranks logged the same parameter digest; returns its JSON
    line."""
    import os

    proc = subprocess.run([sys.executable, "-m", "tensorf_tpu_torch", *argv],
                          env=dict(os.environ, **env), capture_output=True, text=True,
                          timeout=timeout)
    tail = (proc.stdout[-2000:] + proc.stderr[-3000:])
    check(proc.returncode == 0, f"{label}: the CLI exited {proc.returncode}: {tail}")
    out = proc.stdout.splitlines()
    for line in out:
        if "rank " in line and (" of " in line or "digest" in line):
            print(f"{label}: {line}", flush=True)
    digests = [m.rsplit(" ", 1)[-1] for m in out if "parameter digest" in m]
    check(len(digests) == ranks and len(set(digests)) == 1,
          f"{label}: parameter digests {digests}, want {ranks} equal ones")
    return json.loads(out[-1])


def dp_nccl_phase(torch, np, workdir) -> None:
    """dp_nccl: ``--distributed 1`` through the TFTPU_* variables at world
    size 1, NCCL on the card, DP_NCCL_STEPS steps of synth_full; with two
    or more cards visible, NCCL at min(4, count) ranks through
    ``--n_devices`` too (else a line says it was not run)."""
    t0 = time.perf_counter()
    base = ["--config", "configs/synth_full.txt", "--synthetic", "--synthetic_views",
            f"{SCENE['n_train']},{SCENE['n_test']}", "--synthetic_wh", str(SCENE["wh"][0]),
            "--n_iters", str(DP_NCCL_STEPS), "--save_images", "0", "--render_test", "0",
            "--progress_refresh_rate", "5"]
    env = {"TFTPU_COORDINATOR": f"localhost:{free_port()}", "TFTPU_NUM_PROCESSES": "1",
           "TFTPU_PROCESS_ID": "0"}
    row = dp_cli(np, base + ["--distributed", "1", "--basedir", f"{workdir}/nccl1"], env,
                 "dp_nccl", 1, DP_TIMEOUT_S)
    seg = row["segments"][0]
    print(f"dp_nccl: --distributed 1, world size 1, NCCL: {DP_NCCL_STEPS} steps, "
          f"{seg['ms_per_step']:.3f} ms/step, peak {seg['peak_gib']:.2f} GiB", flush=True)
    count = torch.cuda.device_count()
    if count >= 2:
        n = min(4, count)
        row = dp_cli(np, base + ["--n_devices", str(n), "--basedir", f"{workdir}/nccl{n}"], {},
                     f"dp_nccl[{n} cards]", n, DP_TIMEOUT_S)
        print(f"dp_nccl[{n} cards]: --n_devices {n}, NCCL: segments {row['segments']}",
              flush=True)
    else:
        print(f"dp_nccl: NCCL on several cards not run: {count} card visible", flush=True)
    phase_done("dp_nccl", t0)


def run_paths(torch, np, kernels, workdir) -> None:
    """Phases 2-17; prints the kernels line."""
    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
    from tensorf_tpu_torch.profile_step import CUT_SCHEDULE, OVERRIDES, UNSTRATIFIED
    from tensorf_tpu_torch.seed_spread import SEEDS
    from tensorf_tpu_torch.train.loop import build_statics
    from tensorf_tpu_torch.train.step import render_widths

    dev = torch.device("cuda")
    cfg = load_config("configs/synth_full.txt", dict(OVERRIDES, **CUT_SCHEDULE, basedir=workdir))
    print(f"cuts: {SCENE['n_train']}/{SCENE['n_test']} train/test views (config scene 40/8), "
          f"{SCENE['wh'][0]}x{SCENE['wh'][1]} px (800x800), {cfg.n_iters} of 30000 steps with "
          f"upsamples at {cfg.upsamp_list} and alpha masks at {cfg.update_AlphaMask_list} "
          f"(config: [2000..7000], [2000, 4000]), LR decay over {cfg.lr_decay_iters}, progress "
          f"every {cfg.progress_refresh_rate} (500); stratify {cfg.stratify}, sample_budget "
          f"{cfg.sample_budget}, prefilter_budget {cfg.prefilter_budget}, shade_top_k "
          f"{cfg.shade_top_k}, stratify_render {cfg.stratify_render} as written; widths as "
          f"configured", flush=True)
    scene = make_synthetic_scene_arrays(**SCENE)

    t0 = time.perf_counter()
    cases, bf16_synthetic = [], []
    for name, idx, g, n_rows in synthetic_streams(torch, dev, kernel_rays(torch, dev, scene)):
        cases.append(kernel_case(torch, name, idx, g, n_rows))
        if name in BF16_SYNTHETIC:  # the same values in bf16: the bf16 entry point
            bf16_synthetic.append(kernel_case(torch, f"{name}_bf16", idx, g.to(torch.bfloat16),
                                              n_rows))
        del idx, g
    for name, idx, g, n_rows in bf16_branch_streams(torch, dev):
        bf16_synthetic.append(kernel_case(torch, name, idx, g, n_rows))
        del idx, g
    torch.cuda.empty_cache()
    phase_done("kernels", t0)

    t0 = time.perf_counter()
    step_parity_phase(torch, dev, cfg, scene)
    torch.cuda.empty_cache()
    phase_done("step_parity", t0)

    # ---- the main path, as written: counts to 0 just before, read just after ----
    result, main_launches = full_path(torch, np, "main_path", cfg, scene, kernels)
    check(all(seg["strata"] > 0 for seg in result.segments),
          "main_path: a segment ran unstratified")
    last = result.progress[-1]
    print(f"main_path: {main_launches['scatter_add']} scatter-add launches, the per-stratum sum over "
          f"{cfg.n_iters} steps; last progress read (iteration {last['iteration']}) overflow per "
          f"stratum {last['overflow']} (max {MAX_FINAL_OVERFLOW})", flush=True)
    check(max(last["overflow"]) <= MAX_FINAL_OVERFLOW,
          f"main_path: a stratum overflows {max(last['overflow'])} at the last read")
    main_psnr = float(np.mean(result.final_psnrs))

    # the main path's final checkpoint, before the unstratified drive (same
    # expname, overwrt) replaces its logfolder
    t0 = time.perf_counter()
    grid = tuple(result.state.geometry.grid_size)
    print(f"mesh_main: final checkpoint of the main path, grid {grid} "
          f"({int(np.prod(grid))} cells)", flush=True)
    main_mesh, _ = mesh_export(torch, np, kernels, "mesh_main", "configs/synth_full.txt",
                               result.final_path)
    phase_done("mesh_main", t0)
    th_import_phase(torch, np, kernels, workdir, "configs/synth_full.txt", SCENE,
                    result.final_path, main_mesh["verts"])

    t0 = time.perf_counter()
    exactness_phase(torch, np, result.state)
    reference_phase(torch, np, cfg, scene, result)
    bf16_render_phase(torch, np, result.state)
    phase_done("exactness", t0)
    t0 = time.perf_counter()
    serving_phase(torch, np, result.state)
    phase_done("serving", t0)
    t0 = time.perf_counter()
    state = result.state
    widths = render_widths(build_statics(state))
    rows = [q * w for q, w in zip(state.quotas, widths)]
    streams = {}
    for tag, s in (("largest", int(np.argmax(rows))), ("smallest", int(np.argmin(rows)))):
        print(f"streams: {tag} stratum {s}: quota {state.quotas[s]}, width {widths[s]}, "
              f"budget {state.strata_budgets[s]}, lattice {state.strata_n_samples[s]}", flush=True)
        streams.update(capture_streams(torch, state, f"{cfg.n_iters - 1}_{tag}", s))
    del result, state
    torch.cuda.empty_cache()
    phase_done("stratum_streams", t0)

    # ---- the unstratified drive, counts to 0 again ----
    def at_step(it, state):
        if it == FIRST_SEGMENT:  # the 128^3 field, before the events at 200
            streams.update(capture_streams(torch, state, "128_real"))

    flat_cfg = load_config("configs/synth_full.txt",
                           {**OVERRIDES, **CUT_SCHEDULE, **UNSTRATIFIED, "basedir": workdir})
    result, launches = full_path(torch, np, "unstratified", flat_cfg, scene, kernels, at_step)
    check(launches["scatter_add"] == UNSTRATIFIED_LAUNCHES_PER_STEP * flat_cfg.n_iters,
          f"unstratified: scatter_add launched {launches['scatter_add']} times, want "
          f"{UNSTRATIFIED_LAUNCHES_PER_STEP} x {flat_cfg.n_iters}")
    streams.update(capture_streams(torch, result.state, "300_real"))
    del result
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    main_shapes = SYNTHETIC_MAIN_SHAPES + tuple(streams)
    cases += [kernel_case(torch, name, *stream) for name, stream in streams.items()]
    del streams
    torch.cuda.empty_cache()
    phase_done("real_streams", t0)

    # ---- the second path: synth_sphere as written at each seed of
    # seed_spread.SEEDS, counts to 0 again before each; the config's seed
    # (the first) feeds mesh_sphere and resume ----
    t0 = time.perf_counter()
    sphere_scene = make_synthetic_scene_arrays(**SPHERE)
    sphere_psnrs, sphere_launches = {}, None
    resume_base = f"{workdir}/resume"
    for seed in SEEDS:
        sphere_cfg = load_config("configs/synth_sphere.txt", dict(basedir=workdir, seed=seed))
        name = f"sphere_path[seed {seed}]"
        # the config's seed leaves the copy that resume continues
        sphere, launches = drive(torch, name, sphere_cfg, sphere_scene, kernels,
                                 sphere_cfg.n_iters,
                                 resume_snapshot(sphere_cfg, resume_base)
                                 if seed == SEEDS[0] else None)
        check(launches["scatter_add"] > 0, f"{name}: the kernel never launched: {launches}")
        check(all(seg["strata"] > 0 for seg in sphere.segments), f"{name}: a segment ran "
              "unstratified")
        sphere_psnrs[seed] = float(np.mean(sphere.final_psnrs))
        print(f"{name}: final grid {sphere.state.geometry.grid_size}, test psnr "
              f"{sphere_psnrs[seed]:.4f} dB", flush=True)
        if sphere_launches is None:  # the config's seed
            for plan in sphere.plans:
                print(f"{name}: plan " + json.dumps(plan), flush=True)
            sphere_launches, sphere_ckpt = launches, sphere.final_path
            config_seed_cfg = sphere_cfg
            # the next seed's run reuses the logfolder: keep this checkpoint
            kept = f"{workdir}/sphere_config_seed.npz"
            shutil.copyfile(sphere_ckpt, kept)
            sphere_ckpt = kept
        del sphere
        torch.cuda.empty_cache()
    sphere_seed_mean(np, sphere_psnrs)
    sphere_cfg, sphere_psnr = config_seed_cfg, sphere_psnrs[SEEDS[0]]
    phase_done("sphere_path", t0)

    t0 = time.perf_counter()
    _, verts = mesh_export(torch, np, kernels, "mesh_sphere", "configs/synth_sphere.txt",
                           sphere_ckpt)
    radius = np.linalg.norm(verts.astype(np.float64), axis=-1)
    print(f"mesh_sphere: vertex radius about the centre mean {radius.mean():.4f} (want "
          f"{SPHERE_RADIUS} +- {MESH_RADIUS_TOL}), min {radius.min():.4f}, max "
          f"{radius.max():.4f}", flush=True)
    check(abs(radius.mean() - SPHERE_RADIUS) <= MESH_RADIUS_TOL,
          f"mesh_sphere: mean vertex radius {radius.mean()} is not {SPHERE_RADIUS} +- "
          f"{MESH_RADIUS_TOL}")
    phase_done("mesh_sphere", t0)

    t0 = time.perf_counter()
    resume_phase(torch, np, sphere_cfg, sphere_scene, sphere_psnr, resume_base)
    phase_done("resume", t0)

    # ---- the slice's paths: lego (TensorCP, MLP), TensorVM, every shading mode ----
    by_path = {"main_path": main_launches["scatter_add"],
               "sphere_path": sphere_launches["scatter_add"]}
    by_path["lego_path"], by_path["lego_l1_off"] = lego_phase(torch, np, kernels, workdir)
    vm_streams, vm_launches = tensorvm_phase(torch, np, kernels, workdir, scene)
    by_path["tensorvm"] = vm_launches["scatter_add"]
    t0 = time.perf_counter()
    vm_cases = [kernel_case(torch, name, *stream) for name, stream in vm_streams.items()]
    del vm_streams
    torch.cuda.empty_cache()
    phase_done("tensorvm_streams", t0)
    for mode, n in shading_phase(torch, np, kernels, workdir, sphere_scene).items():
        by_path[f"shading_{mode}"] = n
    by_path["flower_path"], flower_cases = flower_phase(torch, np, kernels, workdir)

    # ---- slice 9: the bf16 path, LPIPS ----
    bf16_launches, bf16_cases = bf16_phase(torch, np, kernels, workdir, scene)
    by_path["bf16_path"] = bf16_launches["scatter_add"]
    frame = sphere_scene["test"]["frames"][0]["image"]
    lpips_phase(torch, np, workdir, frame[..., :3] / 255.0)

    # ---- slice 10: data parallelism; each rank counts its own launches ----
    dp_step_parity_phase(torch, np, cfg, scene)
    dp_cfg = load_config("configs/synth_full.txt",
                         dict(OVERRIDES, **CUT_SCHEDULE, basedir=f"{workdir}/dp"))
    by_path["dp_path"] = dp_path_phase(torch, np, dp_cfg, scene, main_psnr)
    dp_nccl_phase(torch, np, workdir)

    # the headline numbers are density_128's, the widest scatter of the
    # unstratified first segment; "shapes" carries every main-path shape
    # beside it, the real streams of both synth_full drives among them.
    # "launches" counts calls of the kernel's entry point on the main path,
    # each of which enqueues the grids in "grids"; every time covers both.
    # The bf16 entry point's path is the bf16 path (the main path runs
    # float32): its launches are that path's, its headline its largest
    # stratum's density stream, and its "shapes" the synthetic main-path
    # streams in bf16 (their float32 times are in the first entry's) and
    # each of the bf16 path's streams beside the float32 entry point's time
    # on the same values widened.
    main_cases = [c for c in cases if c["case"] in main_shapes]
    head = main_cases[0]
    check(head["case"] == "density_128", "the headline kernel case is missing")
    bf16_cases = bf16_synthetic + bf16_cases
    bf16_only = [c for c in bf16_cases if c["dtype"] == "bfloat16"]
    bf16_head = next((c for c in bf16_only if c["case"] == "density_bf16_128"), None)
    check(bf16_head is not None, "the bf16 path's density stream is missing")

    def entry(name, launches, head, shapes, own):
        """``own``: the cases that ran this entry point."""
        _, src, replaces, grids = kernels[name]
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces, "grids": grids,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in own),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": [{k: c[k] for k in CASE_KEYS if k in c} for c in shapes],
        }

    line = {"kernels": [
        dict(entry("scatter_add", main_launches["scatter_add"], head, main_cases, main_cases),
             # each path's launches, its counts set to 0 just before it;
             # TensorCP (lego_path) gathers no plane, so none
             launches_by_path=by_path,
             tensorvm_shapes=[{k: c[k] for k in CASE_KEYS if k in c} for c in vm_cases],
             # flower's last segment: the packed plane and the line footprint tables
             flower_shapes=[{k: c[k] for k in CASE_KEYS if k in c} for c in flower_cases]),
        dict(entry("scatter_add_bf16", bf16_launches["scatter_add_bf16"], bf16_head, bf16_cases,
                   bf16_only),
             launches_by_path={"main_path": main_launches["scatter_add_bf16"],
                               "bf16_path": bf16_launches["scatter_add_bf16"]}),
    ]}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
