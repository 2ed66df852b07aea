#!/usr/bin/env python3
"""Development runs of chip_smoke.py's phases on one NVIDIA GPU.

    python3 chip_dev.py flower           # build the kernels, then the flower phase alone
    python3 chip_dev.py through_resume   # chip_smoke's phases up to and through resume
    python3 chip_dev.py slice9           # the bf16, th_import and lpips phases alone
    python3 chip_dev.py dp               # gloo's collectives on the card, the main path,
                                         # then the data-parallel phases
    python3 chip_dev.py scatter          # the scatter-add's bf16 entry point beside the
                                         # float32 one
    python3 chip_dev.py scatter_counts   # (no GPU) both entry points' L2 reductions on the
                                         # streams scatter saved, the kernels run on the CPU
    python3 chip_dev.py shade_route      # the appearance gather routes timed at the rows
                                         # flower.train's step shades

The scatter modes write under $CHIP_DEV_OUT (default log/chip_dev).

Each imports the ``chip_smoke.py`` of the working directory, so the second
also runs inside another checkout (``cd <tree> && python3 <this file>
through_resume``) to compare two trees' synth_sphere on one card.  Neither
is the acceptance run: that is ``python3 chip_smoke.py`` with no argument.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

# where the scatter modes write their rows and the index streams they keep
OUT_DIR = os.environ.get("CHIP_DEV_OUT", os.path.join("log", "chip_dev"))


def flower(cs) -> None:
    import numpy as np
    import torch

    from tensorf_tpu_torch.ops.scatter_add import KERNEL_NAME, KERNEL_SOURCE, scatter_add
    from tensorf_tpu_torch.utils.cuda_build import build

    kernels = {KERNEL_NAME: (scatter_add, KERNEL_SOURCE, "", [])}
    t0 = time.perf_counter()
    build([*kernels], force=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    work = tempfile.mkdtemp()
    try:
        launches, _ = cs.flower_phase(torch, np, kernels, work)
        print(f"flower launches {launches}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def through_resume(cs) -> None:
    def stop(*_, **__):
        print("chip_dev: stopping before lego_path", flush=True)
        raise SystemExit(0)

    cs.lego_phase = stop
    cs.main()


def slice9(cs) -> None:
    """The kernels built, then slice 9's phases at their own sizes: one
    synth_sphere run (config seed) with the bf16 render of its final state,
    its .th round trip through the CLI and its mesh, LPIPS on an 800x800
    view, and the bf16 path with its kernel cases."""
    import numpy as np
    import torch

    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
    from tensorf_tpu_torch.ops.scatter_add import (KERNEL_NAME, KERNEL_SOURCE, scatter_add,
                                                   scatter_add_bf16)
    from tensorf_tpu_torch.utils.cuda_build import build

    kernels = {KERNEL_NAME: (scatter_add, KERNEL_SOURCE, "", []),
               "scatter_add_bf16": (scatter_add_bf16, KERNEL_SOURCE, "", [])}
    t0 = time.perf_counter()
    for res in build([KERNEL_NAME, "marching"], force=True).values():
        print(f"build[{res.name}] {res.seconds:.1f} s", flush=True)
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"build[{res.name}]: {line.strip()}", flush=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    work = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        cfg = load_config("configs/synth_sphere.txt", dict(basedir=work))
        scene = make_synthetic_scene_arrays(**cs.SPHERE)
        result, launches = cs.drive(torch, "sphere_path", cfg, scene, kernels, cfg.n_iters)
        print(f"sphere_path {time.perf_counter() - t0:.1f} s, psnr "
              f"{float(np.mean(result.final_psnrs)):.4f}", flush=True)
        cs.bf16_render_phase(torch, np, result.state)
        row, _ = cs.mesh_export(torch, np, kernels, "mesh_sphere", "configs/synth_sphere.txt",
                                result.final_path)
        cs.th_import_phase(torch, np, kernels, work, "configs/synth_sphere.txt", cs.SPHERE,
                           result.final_path, row["verts"])
        del result
        cs.lpips_phase(torch, np, work, scene["test"]["frames"][0]["image"][..., :3] / 255.0)
        full = make_synthetic_scene_arrays(**cs.SCENE)
        launches, cases = cs.bf16_phase(torch, np, kernels, work, full)
        print(f"bf16 launches {launches}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def gloo_probe(group, device) -> dict:
    """Which of gloo's collectives take CUDA tensors, on this rank."""
    import torch
    import torch.distributed as dist

    out = {}
    x = torch.full((4,), float(group.rank + 1), device=device)
    for name, op in (("all_reduce", lambda: dist.all_reduce(x.clone())),
                     ("broadcast", lambda: dist.broadcast(x.clone(), src=0)),
                     ("all_gather", lambda: dist.all_gather(
                         [torch.empty_like(x) for _ in range(group.world)], x))):
        try:
            op()
            torch.cuda.synchronize(device)
            out[name] = "ok"
        except Exception as exc:  # noqa: BLE001 - the probe reports what failed
            out[name] = f"{type(exc).__name__}: {str(exc)[:200]}"
    return out


def dp(cs) -> None:
    """The kernels built; gloo's collectives on CUDA tensors on two ranks
    sharing the card; the main path (the dp path's PSNR reference); then
    dp_step_parity, dp_path and dp_nccl."""
    import numpy as np
    import torch

    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
    from tensorf_tpu_torch.ops.scatter_add import (KERNEL_NAME, KERNEL_SOURCE, scatter_add,
                                                   scatter_add_bf16)
    from tensorf_tpu_torch.parallel import spawn
    from tensorf_tpu_torch.profile_step import CUT_SCHEDULE, OVERRIDES
    from tensorf_tpu_torch.utils.cuda_build import build

    kernels = {KERNEL_NAME: (scatter_add, KERNEL_SOURCE, "", []),
               "scatter_add_bf16": (scatter_add_bf16, KERNEL_SOURCE, "", [])}
    t0 = time.perf_counter()
    build([KERNEL_NAME], force=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"gloo on cuda:0, two ranks: {spawn(gloo_probe, (), ['cuda:0', 'cuda:0'], timeout_s=300)}",
          flush=True)
    work = tempfile.mkdtemp()
    try:
        cfg = load_config("configs/synth_full.txt", dict(OVERRIDES, **CUT_SCHEDULE, basedir=work))
        scene = make_synthetic_scene_arrays(**cs.SCENE)
        result, _ = cs.full_path(torch, np, "main_path", cfg, scene, kernels)
        main_psnr = float(np.mean(result.final_psnrs))
        del result
        torch.cuda.empty_cache()
        cs.dp_step_parity_phase(torch, np, cfg, scene)
        dp_cfg = load_config("configs/synth_full.txt",
                             dict(OVERRIDES, **CUT_SCHEDULE, basedir=f"{work}/dp"))
        print(f"dp_path launches {cs.dp_path_phase(torch, np, dp_cfg, scene, main_psnr)}",
              flush=True)
        cs.dp_nccl_phase(torch, np, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def memory_rank(group, device, case) -> dict:
    """GiB peaks of one_step's phases on this rank: forward and backward,
    the all-reduce, Adam."""
    import torch

    from tensorf_tpu_torch.parallel import parity
    from tensorf_tpu_torch.train import step as step_mod

    peaks = {}
    real = step_mod.allreduce_grads

    def mark(name):
        torch.cuda.synchronize(device)
        peaks[name] = torch.cuda.max_memory_allocated(device) / 2**30
        torch.cuda.reset_peak_memory_stats(device)

    def recording(params, grp, extra=None):
        mark("setup_fwd_bwd")
        out = real(params, grp, extra)
        mark("allreduce")
        return out

    step_mod.allreduce_grads = recording
    torch.cuda.reset_peak_memory_stats(device)
    res = parity.one_step(group, device, case)
    mark("adam_and_after")
    peaks["rows"] = sum(res["rows"])
    return peaks


def dp_memory(cs) -> None:
    """One main-path step's memory peaks by phase on 1 and on 2 ranks."""
    import subprocess

    import numpy as np
    import torch

    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
    from tensorf_tpu_torch.ops.scatter_add import KERNEL_NAME
    from tensorf_tpu_torch.parallel import spawn
    from tensorf_tpu_torch.profile_step import CUT_SCHEDULE, OVERRIDES
    from tensorf_tpu_torch.utils.cuda_build import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build([KERNEL_NAME], force=True)
    work = tempfile.mkdtemp()
    try:
        cfg = load_config("configs/synth_full.txt", dict(OVERRIDES, **CUT_SCHEDULE, basedir=work))
        case = cs.dp_step_case(torch, np, cfg, make_synthetic_scene_arrays(**cs.SCENE))
        for devices in (["cuda:0"], ["cuda:0", "cuda:0"]):
            print(f"{len(devices)} rank(s): {spawn(memory_rank, (case,), devices, timeout_s=600)}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def scatter(cs) -> None:
    """The bf16 entry point on the main path's synthetic streams, the new
    branches' cases and the bf16 path's real streams (its first segment
    driven, the last step's largest stratum captured): each entry point
    held to the plain version with kernel_case's tolerance, then timed in
    turns (float32, bf16, bf16, float32), the float32 one on the same
    values widened; and what a small call spends outside its scatter grid
    (torch.profiler's device time of each grid against the wall time a
    call takes, with and without the wrapper's checks and allocation).
    Writes every row to OUT_DIR/scatter_dev.json, and the bf16 path's
    index streams beside it for ``scatter_counts``."""
    import importlib
    import json
    import subprocess

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorf_tpu_torch.config import load_config
    from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
    from tensorf_tpu_torch.profile_step import BF16, CUT_SCHEDULE, OVERRIDES
    from tensorf_tpu_torch.train.loop import build_statics
    from tensorf_tpu_torch.train.step import render_widths
    from tensorf_tpu_torch.utils.cuda_build import build

    # the module (the package's ops namespace exports its function of the same name)
    sa = importlib.import_module("tensorf_tpu_torch.ops.scatter_add")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    for res in build([sa.KERNEL_NAME], force=True).values():
        print(f"build[{res.name}] {res.seconds:.1f} s", flush=True)
        for line in res.log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"build[{res.name}]: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    scene = make_synthetic_scene_arrays(**cs.SCENE)

    # each takes (idx, the bf16 g, the same values widened to float32, n_rows)
    impls = {"f32": lambda idx, g, g32, n: sa.scatter_add(idx, g32, n),
             "bf16": lambda idx, g, g32, n: sa.scatter_add(idx, g, n)}
    streams = []
    rays = cs.kernel_rays(torch, dev, scene)
    for name, idx, g, n_rows in cs.synthetic_streams(torch, dev, rays):
        streams.append((name, idx, g.to(torch.bfloat16), n_rows))
    # the branches no float32 case has: C = 12, rows 8 bytes off
    streams.extend(cs.bf16_branch_streams(torch, dev))

    # the bf16 path's first segment, its last step's largest stratum captured
    work = tempfile.mkdtemp()
    captured = {}
    try:
        cfg = load_config("configs/synth_full.txt", {**OVERRIDES, **CUT_SCHEDULE, **BF16,
                                                     "n_iters": cs.BF16_STEPS, "basedir": work})

        def capture(it, state):
            if it == cfg.n_iters - 1:
                rows = [q * w for q, w in zip(state.quotas, render_widths(build_statics(state)))]
                captured.update(cs.capture_streams(torch, state, "bf16_128",
                                                   int(np.argmax(rows))))

        kernels = {sa.KERNEL_NAME: (sa.scatter_add, sa.KERNEL_SOURCE, "", []),
                   "scatter_add_bf16": (sa.scatter_add_bf16, sa.KERNEL_SOURCE, "", [])}
        cs.drive(torch, "bf16_path", cfg, scene, kernels, cfg.n_iters, capture)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, (idx, g, n_rows) in captured.items():
        # the index stream kept, for counting the reductions off the card
        np.save(os.path.join(OUT_DIR, f"scatter_dev_{name}_idx.npy"), idx.numpy())
        streams.append((name, idx.cuda(), g.cuda(), n_rows))

    rows = []
    for name, idx, g, n_rows in streams:
        M, C = g.shape
        g32 = g.float()
        want = sa.scatter_add_reference(idx, g, n_rows)
        tol = 1e-4 + 1e-6 * float(sa.scatter_add_reference(idx, g.abs(), n_rows).max())
        errs = {}
        for impl, fn in impls.items():
            errs[impl] = float((fn(idx, g, g32, n_rows) - want).abs().max())
        del want
        reps = 10 if M * C > 50_000_000 else 30
        order = list(impls)
        times = {k: [] for k in order}
        for turn in (order, order[::-1]):
            for impl in turn:
                times[impl].append(cs.time_ms(torch, lambda: impls[impl](idx, g, g32, n_rows),
                                              reps))
        mean_run, distinct = cs.stream_stats(torch, idx)
        bound = {s: (M * C * s + M * 4 + n_rows * C * 4) / cs.HBM_BYTES_PER_S * 1e3
                 for s in (2, 4)}
        row = dict(case=name, M=M, C=C, n_rows=n_rows, mean_run=mean_run,
                   distinct_per_64=distinct, bound_bf16_ms=bound[2], bound_f32_ms=bound[4],
                   tol=tol, max_abs_err=errs, ms={k: float(np.mean(v)) for k, v in times.items()},
                   ms_turns=times)
        rows.append(row)
        del g32
        ok = all(e <= tol for e in errs.values())
        print(f"scatter {name} {M}x{C} rows {n_rows} run {mean_run:.2f} distinct/64 "
              f"{distinct:.1f} bound bf16 {bound[2]:.4f} f32 {bound[4]:.4f} | "
              + " ".join(f"{k} {row['ms'][k]:.4f}" for k in order)
              + f" | bf16/f32 {row['ms']['bf16'] / row['ms']['f32']:.3f} share "
              f"{bound[2] / row['ms']['bf16']:.3f} {'ok' if ok else 'ERR ' + str(errs)}",
              flush=True)

    # a small call's fixed cost: the bf16 path's streams
    fixed = []
    for name, idx, g, n_rows in streams:
        if not name.endswith("bf16_128"):
            continue
        out = torch.empty((n_rows, g.shape[1]), dtype=torch.float32, device=dev)
        fn = sa._kernel(torch.bfloat16)
        stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
        args = (idx.data_ptr(), g.data_ptr(), out.data_ptr(), g.shape[0], n_rows, g.shape[1],
                stream)
        wrapper_ms = cs.time_ms(torch, lambda: sa.scatter_add(idx, g, n_rows), 200)
        raw_ms = cs.time_ms(torch, lambda: fn(*args), 200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            sa.scatter_add(idx, g, n_rows)
        host_ms = (time.perf_counter() - t0) / 200 * 1e3  # enqueue only, no sync
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                sa.scatter_add(idx, g, n_rows)
            torch.cuda.synchronize()
        grids = {e.key: e.device_time_total / 1e3 / 50 for e in prof.key_averages()
                 if e.device_time_total > 0 and e.device_type.name == "CUDA"}
        row = dict(case=name, wrapper_ms=wrapper_ms, raw_ctypes_ms=raw_ms,
                   host_enqueue_ms=host_ms, device_ms_per_call=grids)
        fixed.append(row)
        print("fixed_cost " + json.dumps(row), flush=True)
    with open(os.path.join(OUT_DIR, "scatter_dev.json"), "w") as f:
        json.dump({"card": smi, "rows": rows, "fixed": fixed}, f, indent=1)


def scatter_counts(cs) -> None:
    """Off the card (needs g++, no GPU): the float4 and float L2 reductions
    each entry point sends on the synthetic density_128, appearance_128
    and one_row streams (built on the CPU as chip_smoke.py builds them) and
    on the bf16 path's index streams that ``scatter`` saved under OUT_DIR
    (where present), counted by running csrc/scatter_add.cu on the CPU
    under tests/cuda_cpu_emulation.h at an H100's 132 SMs (its launch
    sizes); every value 1.0."""
    import ctypes
    import re
    import subprocess

    import numpy as np
    import torch

    from tensorf_tpu_torch.data.synthetic import make_synthetic_scene_arrays
    from tensorf_tpu_torch.utils import cuda_build

    def emulated(text):
        text = text.replace("#include <cuda_runtime.h>", "")
        text = re.sub(r"asm volatile\(.*?\);", ";", text)
        return re.sub(r"(\w+)<<<(.*?)>>>\(", r"cuda_cpu::launch(\1, \2)(", text)

    work = tempfile.mkdtemp()
    try:
        src = os.path.join(work, "scatter_add.cpp")
        with open(src, "w") as f:
            f.write(emulated((cuda_build.CSRC_DIR / "scatter_add.cu").read_text()))
        lib = os.path.join(work, "libscatter_add.so")
        subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-include",
                        os.path.join(os.getcwd(), "tests", "cuda_cpu_emulation.h"), "-o", lib, src],
                       check=True)
        handle = ctypes.CDLL(lib)
        handle.cuda_cpu_set_sm_count(132)
        handle.cuda_cpu_reductions.restype = ctypes.c_longlong
        entries = {"f32": "tftorch_scatter_add_f32", "bf16": "tftorch_scatter_add_bf16"}
        streams = []
        cpu = torch.device("cpu")
        rays = cs.kernel_rays(torch, cpu, make_synthetic_scene_arrays(**cs.SCENE))
        for name, idx, g, n_rows in cs.synthetic_streams(torch, cpu, rays):
            if name in ("density_128", "appearance_128", "one_row"):
                streams.append((name, idx.numpy(), g.shape[1], n_rows))
        for name, C in (("appearance_bf16_128", 192), ("density_bf16_128", 64)):
            path = os.path.join(OUT_DIR, f"scatter_dev_{name}_idx.npy")
            if os.path.exists(path):
                idx = np.load(path).astype(np.int32)
                streams.append((name, idx, C, int(idx.max()) + 1))
        for name, idx, C, n_rows in streams:
            M = idx.shape[0]
            counts = {}
            for impl, entry in entries.items():
                # 1.0 in float32, or in bf16 (its upper 16 bits)
                g = np.ones((M, C), np.float32) if impl == "f32" else np.full((M, C), 0x3F80,
                                                                                np.uint16)
                out = np.zeros((n_rows, C), np.float32)
                fn = getattr(handle, entry)
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                                       ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                handle.cuda_cpu_reductions()
                check = fn(idx.ctypes.data, g.ctypes.data, out.ctypes.data, M, n_rows, C, None)
                counts[impl] = handle.cuda_cpu_reductions()
                want = np.bincount(idx, minlength=n_rows) * C
                if check != 0 or not np.array_equal(out.sum(axis=1), want):
                    raise RuntimeError(f"{impl} on {name}: wrong sums (error {check})")
            runs = 1 + int((idx[1:] != idx[:-1]).sum())
            print(f"reductions {name} {M}x{C}: runs in stream order x columns "
                  f"{runs * (C // 4)}; " + ", ".join(f"{k} {v}" for k, v in counts.items()),
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def shade_route(cs) -> None:
    """The appearance gather routes at the rows flower.train's step shades:
    portbench's made state of the cell (seed 1), one step run with
    render_rays' appearance input captured (the samples over the weight
    threshold), then on those rows the appearance features' forward and
    backward by each route, timed with CUDA events in turns (A B C C B A,
    ``ROUNDS`` times, 5 calls a reading): the footprint tables with the
    one-hot lines (``app_feature_fused`` as the step runs it), the same
    with the lines' footprint tables, and the direct taps
    (``app_feature``: grid_sample_2d / grid_sample_1d)."""
    import statistics
    import subprocess

    import torch

    from portbench.run import Trainer, load_cell, set_cache_dirs, setup
    from tensorf_tpu_torch.models import tensorf
    from tensorf_tpu_torch.ops.scatter_add import KERNEL_NAME
    from tensorf_tpu_torch.utils.cuda_build import build

    ROUNDS, CALLS = 8, 5
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    set_cache_dirs()
    build([KERNEL_NAME], force=True)
    device = torch.device("cuda")
    s = setup(load_cell("flower.train"), 1, device)
    tr = Trainer(s, 1, device)
    field = s.state.field
    seen = []
    inner = field.app_feature_fused

    def capture(xyz, mask):
        seen.append((xyz.detach().clone(), mask))
        return inner(xyz, mask)

    field.app_feature_fused = capture
    tr.step()
    del field.app_feature_fused
    (pts, mask), = seen
    cot = torch.randn((pts.shape[0], field.cfg.app_dim), device=device,
                      generator=torch.Generator(device=device).manual_seed(0))
    one_hot = tensorf._ONE_HOT_MAX_BYTES

    def footprint_lines(xyz, m):
        tensorf._ONE_HOT_MAX_BYTES = 0
        try:
            return field.app_feature_fused(xyz, m)
        finally:
            tensorf._ONE_HOT_MAX_BYTES = one_hot

    routes = {"footprint, one-hot lines": field.app_feature_fused,
              "footprint, footprint lines": footprint_lines,
              "direct taps": field.app_feature}

    def reading(route):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            field.zero_grad(set_to_none=True)
            torch.sum(route(pts, mask) * cot).backward()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / CALLS

    outs = {name: route(pts, mask).detach() for name, route in routes.items()}
    for name in routes:
        reading(routes[name])  # warm-up
    ms = {name: [] for name in routes}
    order = list(routes)
    for _ in range(ROUNDS):
        for name in order + order[::-1]:
            ms[name].append(reading(routes[name]))
    base = outs[order[0]]
    print(f"shade_route: {pts.shape[0]} shaded rows of {tr.statics.n_samples} x "
          f"{s.cfg.batch_size} slots, grid {tuple(s.state.geometry.grid_size)}", flush=True)
    for name in order:
        q = statistics.quantiles(ms[name], n=4)
        print(f"shade_route: {name}: forward+backward median {statistics.median(ms[name]):.4f} "
              f"ms (quartiles {q[0]:.4f} / {q[2]:.4f}, {len(ms[name])} readings), max |out - "
              f"{order[0]}| {float((outs[name] - base).abs().max()):.3g}", flush=True)


def main(argv) -> None:
    modes = {"flower": flower, "through_resume": through_resume, "slice9": slice9, "dp": dp,
             "dp_memory": dp_memory, "scatter": scatter, "scatter_counts": scatter_counts,
             "shade_route": shade_route}
    if len(argv) != 1 or argv[0] not in modes:
        sys.exit(f"usage: chip_dev.py {{{'|'.join(modes)}}}")
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    modes[argv[0]](chip_smoke)


if __name__ == "__main__":
    main(sys.argv[1:])
