"""Starting the ranks of a data-parallel run.

``n_devices N`` (one launch, the JAX package's N-device mesh in one
process): ``spawn`` starts one process per rank with the spawn start
method, each on its own card (``rank_devices``), and returns what each
rank's function returned.  ``distributed 1`` (one process per host in the
JAX package): the ranks are started outside the program, by torchrun
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or with the JAX package's own ``TFTPU_COORDINATOR``,
``TFTPU_NUM_PROCESSES`` and ``TFTPU_PROCESS_ID``, and ``join_from_env``
joins this one, on card ``LOCAL_RANK``.

A rank's function is ``fn(group, device, *args)``; it must be defined in a
module the child can import (the spawn start method re-imports it).  A
rank that raises or exits makes ``spawn`` kill the others and raise
``RankFailed`` with that rank's exit code, as does the launch's timeout.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .mesh import COLLECTIVE_TIMEOUT_S, RankGroup, choose_backend, destroy_group, init_group


class RankFailed(RuntimeError):
    """A rank of a spawned launch failed; ``exitcode`` is its exit code
    (the watchdog's 17 for a wedge), 1 for an exception or a timeout."""

    def __init__(self, msg: str, exitcode: int = 1):
        super().__init__(msg)
        self.exitcode = exitcode


def rank_devices(n_devices: int, device=None) -> List[torch.device]:
    """The devices of an ``n_devices`` launch, one per rank.  On the cards:
    the first ``n_devices`` visible ones, every visible one for 0, all of
    them when fewer are visible (make_mesh's ``devs[:n]``).  On the CPU:
    ``n_devices`` ranks (0: one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [dev] * max(int(n_devices), 1)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.index is not None:
        # an explicit card is one rank
        return [dev]
    n = count if n_devices <= 0 else min(int(n_devices), count)
    return [torch.device("cuda", i) for i in range(n)]


def env_rank() -> Optional[Tuple[int, int, int, str]]:
    """(rank, world, local rank, init method) of a rank started outside the
    program, from torchrun's variables or the TFTPU_* ones; None without
    either."""
    if os.environ.get("TFTPU_COORDINATOR"):
        rank = int(os.environ["TFTPU_PROCESS_ID"])
        world = int(os.environ["TFTPU_NUM_PROCESSES"])
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        return rank, world, local, f"tcp://{os.environ['TFTPU_COORDINATOR']}"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        return rank, world, int(os.environ.get("LOCAL_RANK", 0)), "env://"
    return None


def join_from_env(n_devices: int, device=None,
                  timeout_s: float = COLLECTIVE_TIMEOUT_S) -> RankGroup:
    """Join a ``distributed`` run as the rank the environment names, on
    ``cuda:LOCAL_RANK`` (or the CPU when ``device`` asks): each rank draws
    from its own id pool.  ``n_devices`` must be 0 or the world size."""
    found = env_rank()
    if found is None:
        raise ValueError(
            "distributed 1 needs the rank's environment: torchrun's RANK, WORLD_SIZE, "
            "LOCAL_RANK, MASTER_ADDR and MASTER_PORT, or TFTPU_COORDINATOR, "
            "TFTPU_NUM_PROCESSES and TFTPU_PROCESS_ID"
        )
    rank, world, local, init_method = found
    if n_devices not in (0, world):
        raise ValueError(f"n_devices {n_devices} with distributed 1 must be 0 or the world "
                         f"size {world}: each rank has one device")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if local >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} visible cards")
        dev = torch.device("cuda", local)
    # a rank of its own per card under torchrun; the CPU's ranks use gloo
    backend = "nccl" if dev.type == "cuda" else "gloo"
    return init_group(rank, world, dev, init_method, backend, pooled=True, timeout_s=timeout_s)


def _report(results, report) -> None:
    # what the rank printed is out before the parent may kill it (spawn
    # kills a rank still exiting after its join timeout)
    sys.stdout.flush()
    sys.stderr.flush()
    results.put(report)


def _rank_main(fn, rank, world, device, init_method, backend, timeout_s, args, results):
    for stream in (sys.stdout, sys.stderr):
        # the ranks share the launch's stdout and stderr: a line leaves in
        # one write, so it arrives whole beside the other ranks' lines
        # (unbuffered, print writes the text and the newline apart) and
        # as soon as it is printed
        if hasattr(stream, "reconfigure"):
            stream.reconfigure(line_buffering=True, write_through=False)
    if torch.device(device).type == "cpu":
        # the ranks share the threads their launch was given
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        group = init_group(rank, world, device, init_method, backend, timeout_s=timeout_s)
        try:
            value = fn(group, torch.device(device), *args)
        finally:
            destroy_group()
        _report(results, (rank, True, value))
    except BaseException as exc:  # noqa: BLE001 - reported to the parent, then re-raised
        code = exc.code if isinstance(exc, SystemExit) and isinstance(exc.code, int) else 1
        _report(results, (rank, False, (code, traceback.format_exc())))
        raise SystemExit(code or 1)


def spawn(fn: Callable, args: tuple = (), devices: Sequence = ("cpu", "cpu"), *,
          timeout_s: Optional[float] = None,
          collective_timeout_s: float = COLLECTIVE_TIMEOUT_S) -> list:
    """Run ``fn(group, device, *args)`` on ``len(devices)`` ranks, rank r on
    ``devices[r]``, and return their return values in rank order.  The
    ranks meet at a file store in a fresh temporary directory (no port is
    opened); the backend follows from the devices (``choose_backend``).
    Raises ``RankFailed`` when a rank fails or ``timeout_s`` passes, after
    killing every rank still running."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    world = len(devices)
    backend = choose_backend(devices)
    rdzv = tempfile.mkdtemp(prefix="tftorch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, str(devices[r]), f"file://{rdzv}/store", backend,
                               collective_timeout_s, args, results))
             for r in range(world)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    values, failure = {}, None
    try:
        for p in procs:
            p.start()
        while len(values) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in values]
                if dead:
                    # a rank that exited without a report (os._exit, a signal)
                    time.sleep(0.5)
                    if results.empty():
                        r, code = dead[0]
                        failure = RankFailed(f"rank {r} exited with code {code}",
                                             code if code and code > 0 else 1)
                elif deadline is not None and time.monotonic() > deadline:
                    failure = RankFailed(f"the launch passed its {timeout_s:.0f} s timeout")
                continue
            if ok:
                values[rank] = value
            else:
                code, tb = value
                failure = RankFailed(f"rank {rank} failed (exit code {code}):\n{tb}", code)
        if failure is None:
            for p in procs:
                p.join(timeout=60)
        if failure is not None:
            # the others fail at their next collective once a rank is gone:
            # report the first exit that was not such a follow-on failure
            time.sleep(1.0)
            codes = [(r, p.exitcode) for r, p in enumerate(procs)
                     if p.exitcode not in (None, 0, 1) and p.exitcode > 0]
            if codes and failure.exitcode == 1:
                r, code = codes[0]
                failure = RankFailed(f"rank {r} exited with code {code}; then {failure}", code)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(rdzv, ignore_errors=True)
    if failure is not None:
        raise failure
    return [values[r] for r in range(world)]
