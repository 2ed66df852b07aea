"""Where a train step's or a served frame's device time goes: torch.profiler
over a few steps, or over one frame.

    python -m tensorf_tpu_torch.profile_step [--config configs/lego.txt |
        --config configs/flower.txt] [--last_segment | --serve] [--unstratified] [--bf16]

Trains a config's model as the config is written (ray stratification,
sample budgets and top-K shading on) on its in-memory composite scene:
configs/synth_full.txt (the default) on 8 views of 200x200 px, and
configs/lego.txt on Blender's 100 train and 200 test views of 800x800 px
(only the views its indices select are traced), configs/flower.txt on the
in-memory forward-facing capture of 34 views at 1008x756 (flower's
images_4 size; 29 train, 5 test); ``--unstratified`` runs
it with stratification and budgets off instead, as the port ran before
it had them; ``--bf16`` sets grid_dtype, line_dtype and compute_dtype to
bfloat16.  By default it takes WARMUP steps of the first (128^3) segment
unprofiled, past the initial loss plateau, then profiles STEPS steps.
With ``--last_segment`` it runs the cut schedule chip_smoke.py drives
(synth_full's CUT_SCHEDULE: 450 steps, both alpha-mask events, five
upsamples to n_to_reso(300^3) on the shrunk bbox; lego's LEGO_CUT: 600
steps, the upsample and alpha mask at 400; flower's FLOWER_CUT: 450 steps,
four upsamples to n_to_reso(640^3), the alpha mask at 250), profiles the
last STEPS steps
of every segment and prints each window's busy and idle share; the tables
are the last segment's.  It prints,
per CUDA kernel, its device time per step and share, then the same time
by the torch op (and input shapes) that launched it, the step's wall time,
the device activities a step enqueues, and the device's busy and idle
share.  Busy time is the union of the kernel, memcpy and memset intervals;
user-annotation rows, which span kernels already counted, are left out.
The profiler slows the host, so the idle share is taken against the wall
time of the STEPS unprofiled steps just before each profiled window (the
profiled window's own wall time is printed beside it).  With ``--serve``
it trains the cut schedule, then serves one 800x800 view of its final
state (test pose 0, the focal scaled to 800x800, rays built on the
device by rays_from_pose; flower: test view 0 at 1008x756, uniform, as
NDC rays serve) through the eval's handle (stratified serving): one
warm frame, one timed frame, one profiled frame, and the same busy, idle
and table rows per frame.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .config import load_config
from .data.synthetic import make_forward_facing_scene, make_synthetic_scene_arrays
from .ops.rays import get_ray_directions
from .render.chunked import rays_from_pose
from .train.loop import make_handle, reconstruction, train_steps

CONFIG = "configs/synth_full.txt"
LEGO = "configs/lego.txt"
FLOWER = "configs/flower.txt"
OVERRIDES = dict(progress_refresh_rate=10**9)
# the port's drive before it had stratification and budgets
UNSTRATIFIED = dict(stratify=0, sample_budget=0, prefilter_budget=0)
# every dtype option at bfloat16: bf16 plane tables (their backward through
# the scatter-add's bf16 entry point), bf16 line one-hots, the bf16 MLP
BF16 = dict(grid_dtype="bfloat16", line_dtype="bfloat16", compute_dtype="bfloat16")
# synth_full's 30000-step schedule cut to 450 steps: the same events, 50
# steps apart.  The LR still decays over the config's 30000 steps: decayed
# over 450, it slows the field's escape from its initial plateau past the
# first alpha mask at 200, which then finds nothing occupied.  Progress
# (and the budget overflow read that may raise a budget) every 25 steps,
# twice a segment, where the config's 500 would read once in the run.
CUT_SCHEDULE = dict(n_iters=450, lr_decay_iters=30000, upsamp_list=[200, 250, 300, 350, 400],
                    update_AlphaMask_list=[200, 300], vis_every=200, save_ckpt_every=[],
                    progress_refresh_rate=25)
# configs/lego.txt's 3000-step schedule cut to 600 steps as CUT_SCHEDULE
# cuts synth_full's: its one event in reach (upsample and alpha mask at
# 2000) moves to the same fraction of the run, 400, the later ones alike,
# out of reach.  The LR decays over the config's 3000 steps.  The test set
# is scored at 400 (vis_every 2000, cut alike) and after the last step
# (render_test, which lego.txt leaves off).
LEGO_CUT = dict(n_iters=600, lr_decay_iters=3000, upsamp_list=[400, 600, 800, 1100, 1400],
                update_AlphaMask_list=[400, 800], vis_every=400, train_vis_every=400,
                render_test=1)
# configs/flower.txt's 25000-step schedule cut to 450 steps as
# CUT_SCHEDULE cuts synth_full's: the first segment keeps 200 steps (the
# loss bar reads its end), then every event 50 steps apart in the config's
# order — upsample, alpha mask (shrink), three upsamples — so the last 49
# steps run at n_to_reso(640^3).  The LR decays over the config's 25000
# steps; progress every 10 steps as written; no evaluation before the end
# (vis_every 1000 as written lies past it); the spiral render_path is left
# to the caller.
FLOWER_CUT = dict(n_iters=450, lr_decay_iters=25000, upsamp_list=[200, 300, 350, 400],
                  update_AlphaMask_list=[250], render_path=0)
# each config's in-memory scene and cut schedule; lego's scene has
# Blender's split sizes, so its train_idxs and test_idxs select as written;
# flower's is an LLFF capture (make_forward_facing_scene's arguments)
PATHS = {
    CONFIG: (dict(n_train=8, n_test=2, wh=(200, 200), scene="composite"), CUT_SCHEDULE),
    LEGO: (dict(n_train=100, n_test=200, wh=(800, 800), scene="composite"), LEGO_CUT),
    FLOWER: (dict(n_views=34, wh=(1008, 756)), FLOWER_CUT),
}
WARMUP = 160
STEPS = 5
TOP = 25
# the served view: a test camera at synth_full's (and Blender's) 800x800
# test resolution; synth_full's 200x200 scene scales its focal x4
SERVE_WH = 800
SERVE_SCALE = 4


def path_scene(config: str, cfg):
    """``config``'s in-memory scene (PATHS), tracing only the views that
    ``cfg``'s train_idxs and test_idxs select, where it sets them."""
    scene, _ = PATHS[config]
    if cfg.dataset_name == "llff":
        return make_forward_facing_scene(**scene)
    views = {split: idxs for split, idxs in (("train", cfg.train_idxs), ("test", cfg.test_idxs))
             if idxs}
    return make_synthetic_scene_arrays(**scene, views=views or None)


def schedule_ends(cut) -> list:
    """The last step of each segment of a cut schedule: the step before
    each event in reach, and the run's last step."""
    events = sorted(e for e in {*cut["upsamp_list"], *cut["update_AlphaMask_list"]}
                    if e < cut["n_iters"])
    return events + [cut["n_iters"] - 1]


def serving_view(test_ds, scale: int, device):
    """(directions (H*W, 3), pose (3|4, 4)) float32 on ``device``: test view
    0 at ``scale`` times the dataset's resolution, its focal scaled alike,
    directions normalized as the dataset's are.  rays_from_pose turns them
    into the frame's rays."""
    W, H = test_ds.img_wh
    focal = test_ds.focal * scale
    dirs = get_ray_directions(H * scale, W * scale, [focal, focal])
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).reshape(-1, 3)
    return (torch.as_tensor(dirs.astype(np.float32), device=device),
            torch.as_tensor(np.asarray(test_ds.poses[0], np.float32), device=device))


def _device_spans(events):
    return sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type.name == "CUDA" and not e.is_user_annotation
    )


def _busy_ms(events) -> float:
    """Length of the union of the device activity intervals, in ms."""
    spans = _device_spans(events)
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy / 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=CONFIG, choices=sorted(PATHS),
                        help="the config to train, on its in-memory scene")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--last_segment", action="store_true",
                      help="profile the end of every segment of the cut schedule, "
                           "not the first segment")
    mode.add_argument("--serve", action="store_true",
                      help="profile one 800x800 stratified frame of the cut schedule's "
                           "final state")
    parser.add_argument("--unstratified", action="store_true",
                        help="stratification and sample budgets off")
    parser.add_argument("--bf16", action="store_true",
                        help="grid_dtype, line_dtype and compute_dtype bfloat16 (BF16): the "
                             "plane gathers' backward goes through the scatter-add's bfloat16 "
                             "entry point")
    args = parser.parse_args(argv)
    overrides = dict(OVERRIDES, **(UNSTRATIFIED if args.unstratified else {}),
                     **(BF16 if args.bf16 else {}))
    cut = PATHS[args.config][1]
    # (first step, profiler, profiled wall s, wall s of the unprofiled steps before)
    windows = []
    if args.last_segment:
        ends = schedule_ends(cut)
    elif args.serve:
        ends = []
    else:
        ends = [WARMUP + STEPS - 1]
    plain_t0 = {}
    per, unit = (1, "frame") if args.serve else (STEPS, "step")

    def tracer():
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True)

    def on_step(it: int, *_) -> None:  # runs after step ``it`` is enqueued
        if it + 2 * STEPS in ends:
            torch.cuda.synchronize()
            plain_t0[it + 2 * STEPS] = time.perf_counter()
        if it + STEPS in ends:
            torch.cuda.synchronize()
            now = time.perf_counter()
            windows.append([it + 1, tracer(), now, now - plain_t0[it + STEPS]])
            windows[-1][1].__enter__()
        if it in ends:
            torch.cuda.synchronize()
            windows[-1][2] = time.perf_counter() - windows[-1][2]
            windows[-1][1].__exit__(None, None, None)

    def summary(prof, wall, plain) -> str:
        busy = _busy_ms(prof.events()) / per
        plain_ms = plain * 1e3 / per
        return (f"wall {plain_ms:.3f} ms/{unit} (profiled {wall * 1e3 / per:.3f}), device busy "
                f"{busy:.3f} ms/{unit}, idle {100 * (1 - busy / plain_ms):.1f}%, "
                f"{len(_device_spans(prof.events())) // per} device activities/{unit}")

    if args.last_segment or args.serve:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = load_config(args.config, {**overrides, **cut, "basedir": tmp, "render_test": 0})
            result = reconstruction(cfg, path_scene(args.config, cfg), "cuda", save_images=False,
                                    on_step=on_step, log=lambda s: None)
        last = result.segments[-1]
        where = (f"the last {STEPS} steps of the cut schedule: grid {last['grid']}, "
                 f"{last['n_samples']} samples, alpha mask {last['masked']}, "
                 f"top-{cfg.shade_top_k}, "
                 f"{last['strata']} strata, budgets {last['budgets']}, "
                 f"lattices {last['lattices']}")
        for seg, (first, prof, wall, plain) in zip(result.segments, windows):
            print(f"segment {seg['start']}..{seg['end']} steps {first}..{first + STEPS - 1}: "
                  f"grid {seg['grid']} strata {seg['strata']} density samples/step "
                  f"{seg['samples_per_step']}: {summary(prof, wall, plain)}")
    else:
        cfg = load_config(args.config, overrides)
        train_steps(cfg, WARMUP + STEPS, device="cuda", scene=path_scene(args.config, cfg),
                    on_step=on_step, log=lambda s: None)
        where = f"{STEPS} profiled steps after {WARMUP}"
    if args.serve:
        state = result.state
        handle = make_handle(state)
        if state.ndc_ray:
            # an NDC frame is test view 0 as the dataset projected it
            view = torch.as_tensor(state.test_ds.all_rays[0].reshape(-1, 6), device="cuda")

            def frame():
                return handle.render(view)
            n_rays = view.shape[0]
        else:
            directions, c2w = serving_view(state.test_ds, SERVE_WH // state.test_ds.img_wh[0],
                                           "cuda")

            def frame():  # the eval's render; returns host arrays
                return handle.render(rays_from_pose(directions, c2w))
            n_rays = directions.shape[0]

        frame()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, n_valid = frame()
        plain = time.perf_counter() - t0
        prof = tracer()
        with prof:
            t0 = time.perf_counter()
            frame()
            wall = time.perf_counter() - t0
        windows.append([0, prof, wall, plain])
        where = (f"one {n_rays}-ray {'stratified' if handle.stratified else 'uniform'} "
                 f"frame of the final state: grid {state.geometry.grid_size}, {state.n_samples} "
                 f"samples, top-{cfg.shade_top_k}, {n_valid} shaded samples, overflow "
                 f"{handle.max_overflow}")
    _, prof, wall, plain = windows[-1]
    annotations = {e.key for e in prof.events() if e.is_user_annotation}
    rows = [
        (e.key, e.device_time_total / 1e3 / per, e.count // per)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type.name == "CUDA"
        and e.key not in annotations
    ]
    busy_ms = _busy_ms(prof.events()) / per
    print(f"{torch.cuda.get_device_name(0)}; {args.config} "
          f"{'unstratified' if args.unstratified else 'as written'}"
          f"{', every dtype bfloat16' if args.bf16 else ''}; {cfg.model_name} "
          f"{cfg.shadingMode}; {where}")
    print(f"{summary(prof, wall, plain)}; kernel rows sum to "
          f"{sum(ms for _, ms, _ in rows):.3f} ms/{unit}")
    print(f"{'ms/' + unit:>9} {'share':>6} {'calls':>6}  kernel")
    for key, ms, calls in sorted(rows, key=lambda r: -r[1])[:TOP]:
        print(f"{ms:9.3f} {100 * ms / busy_ms:5.1f}% {calls:6d}  {key[:110]}")
    # the same device time attributed to the torch ops that launched it
    ops = [
        (e.key, str(e.input_shapes)[:70], e.self_device_time_total / 1e3 / per,
         e.count // per)
        for e in prof.key_averages(group_by_input_shape=True)
        if e.self_device_time_total > 0 and e.device_type.name == "CPU"
    ]
    print(f"{'ms/' + unit:>9} {'share':>6} {'calls':>6}  op [input shapes]")
    for key, shapes, ms, calls in sorted(ops, key=lambda r: -r[2])[:TOP]:
        print(f"{ms:9.3f} {100 * ms / busy_ms:5.1f}% {calls:6d}  {key} {shapes}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
