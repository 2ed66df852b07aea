#!/usr/bin/env python3
"""Development runs of chip_smoke.py's phases on one NVIDIA GPU.

    python3 chip_dev.py flower           # build the kernels, then the flower phase alone
    python3 chip_dev.py through_resume   # chip_smoke's phases up to and through resume
    python3 chip_dev.py slice9           # the bf16, th_import and lpips phases alone
    python3 chip_dev.py dp               # gloo's collectives on the card, the main path,
                                         # then the data-parallel phases

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


def main(argv) -> None:
    modes = {"flower": flower, "through_resume": through_resume, "slice9": slice9, "dp": dp,
             "dp_memory": dp_memory}
    if len(argv) != 1 or argv[0] not in modes:
        sys.exit(f"usage: chip_dev.py {{{'|'.join(modes)}}}")
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    modes[argv[0]](chip_smoke)


if __name__ == "__main__":
    main(sys.argv[1:])
