"""Each process of a test run takes its share of the host's cores.

torch (and MKL under it) opens a pool of ``os.cpu_count()`` OpenMP threads
in every process that imports it.  Under pytest-xdist every worker would,
and ``-n W`` workers on a host of C cores would then spin W x C threads
against each other at the barrier of every small op.  So each process that
runs tests takes ``max(1, os.cpu_count() // W)`` threads (W is 1 without
xdist), whatever its environment held, and writes that to
``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS``: the CLI tests' subprocesses
and the ranks that ``parallel/launch.py::spawn`` starts inherit it.

xdist's controller loads this file too, with no worker count, and its
environment is what its workers inherit: it runs no test and sets nothing,
so each worker works out its own share.  A worker has
``PYTEST_XDIST_WORKER_COUNT`` in its environment before this file is
imported, so it takes its share before ``tests/conftest.py`` or a test
module imports torch.  ``tests/conftest.py`` holds the JAX package's
harness; XLA's thread pools are not OpenMP's and are left as they are.
"""

import os
import sys


def _take_share(workers: int) -> None:
    n = max(1, (os.cpu_count() or 1) // max(workers, 1))
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[name] = str(n)
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(n)


if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _take_share(int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))


def pytest_configure(config):
    # a run without xdist is one process with the whole host; the
    # controller of a run with it (-n W) leaves its environment alone
    if "PYTEST_XDIST_WORKER_COUNT" not in os.environ and not getattr(
            config.option, "numprocesses", None):
        _take_share(1)
