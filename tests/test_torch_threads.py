"""Each process of a test run takes its share of the host's cores (the
repo-root conftest.py): torch's thread count in a test, in a subprocess a
test starts, and in the workers of an xdist run whose caller handed them
the whole host's count."""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XDIST_VARIABLES = ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT", "PYTEST_XDIST_TESTRUNUID")


def _share() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


def test_torch_takes_its_share_of_the_cores():
    assert torch.get_num_threads() == _share()


def test_a_subprocess_inherits_the_share():
    proc = subprocess.run(
        [sys.executable, "-c", "import os, torch; print(os.environ.get('OMP_NUM_THREADS'), "
         "os.environ.get('MKL_NUM_THREADS'), torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == [str(_share())] * 3


def test_xdist_workers_do_not_keep_the_controllers_count():
    """A run of two workers started with the whole host's count in its
    environment, as a controller that set it would hand it to them: each
    worker takes half the cores."""
    env = {k: v for k, v in os.environ.items() if k not in XDIST_VARIABLES}
    env.update(OMP_NUM_THREADS=str(os.cpu_count()), MKL_NUM_THREADS=str(os.cpu_count()),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
         "tests/test_torch_threads.py::test_torch_takes_its_share_of_the_cores",
         "tests/test_torch_threads.py::test_a_subprocess_inherits_the_share"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "2 passed" in proc.stdout, proc.stdout[-3000:]
