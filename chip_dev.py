#!/usr/bin/env python3
"""Development runs of chip_smoke.py's phases on one NVIDIA GPU.

    python3 chip_dev.py flower           # build the kernels, then the flower phase alone
    python3 chip_dev.py through_resume   # chip_smoke's phases up to and through resume
    python3 chip_dev.py slice9           # the bf16, th_import and lpips phases alone

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


def main(argv) -> None:
    modes = {"flower": flower, "through_resume": through_resume, "slice9": slice9}
    if len(argv) != 1 or argv[0] not in modes:
        sys.exit(f"usage: chip_dev.py {{{'|'.join(modes)}}}")
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    modes[argv[0]](chip_smoke)


if __name__ == "__main__":
    main(sys.argv[1:])
