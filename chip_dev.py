#!/usr/bin/env python3
"""Development runs of chip_smoke.py's phases on one NVIDIA GPU.

    python3 chip_dev.py flower           # build the kernels, then the flower phase alone
    python3 chip_dev.py through_resume   # chip_smoke's phases up to and through resume

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


def main(argv) -> None:
    modes = {"flower": flower, "through_resume": through_resume}
    if len(argv) != 1 or argv[0] not in modes:
        sys.exit(f"usage: chip_dev.py {{{'|'.join(modes)}}}")
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    modes[argv[0]](chip_smoke)


if __name__ == "__main__":
    main(sys.argv[1:])
