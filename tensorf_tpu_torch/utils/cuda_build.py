"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>_<digest>.so`` inside the package (a directory git
ignores), at first use.  The digest covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing is
built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# sm_90a (not sm_90): Hopper-only instructions (wgmma, setmaxnreg) exist
# only for that target.  -Xptxas -v reports registers, shared memory and
# spills per kernel in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


class BuildResult(NamedTuple):
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already on disk
    log: str  # nvcc's output (ptxas register/spill report), "" when cached


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, not under CUDA_HOME or "
            "/usr/local/cuda); the CUDA kernels cannot be built"
        )
    return path


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str], force: bool = False) -> Dict[str, BuildResult]:
    """Compile each named kernel source, one nvcc process per source, all
    started together.  Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results = {}
    to_build = []
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            results[name] = BuildResult(name, out, 0.0, "")
        else:
            to_build.append((name, out))
    nvcc = nvcc_path() if to_build else ""
    started = {}
    for name, out in to_build:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, out, tmp, time.perf_counter())
    failures = []
    for name, (proc, out, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        results[name] = BuildResult(name, out, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load_library(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed (cached per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _loaded[name] = lib
    return lib
