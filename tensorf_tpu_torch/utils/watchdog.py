"""In-loop device-wedge watchdog (a port of tensorf_tpu/utils/watchdog.py).

A device can wedge mid-run: a launched step never completes, the next
host read blocks forever, and a multi-hour run dies silently.  So:

  * the train loop beats the watchdog once per iteration and once per
    rendered image (host-side, free);
  * a daemon thread tracks the age of the last beat AND the newest write
    under the build directories (a long nvcc or g++ build at first use
    shows up as fresh writes there, so builds never false-fire);
  * if both exceed the timeout, the watchdog logs a diagnostic and
    hard-exits with ``EXIT_WEDGED`` so the operator (or the CLI's
    ``--auto_resume`` supervisor) can relaunch with ``--resume 1``, which
    continues from the newest periodic checkpoint in the logfolder.

``os._exit`` is deliberate: a wedged device blocks the main thread inside
an uninterruptible synchronisation; only a process exit is resumable.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional, Sequence

EXIT_WEDGED = 17


def _newest_mtime(paths: Sequence[str]) -> float:
    """Newest file mtime under the given dirs (0.0 if none exist)."""
    newest = 0.0
    for root in paths:
        try:
            for dirpath, _, files in os.walk(root):
                for f in files:
                    try:
                        newest = max(
                            newest, os.path.getmtime(os.path.join(dirpath, f))
                        )
                    except OSError:
                        pass
        except OSError:
            pass
    return newest


class Watchdog:
    """Fires ``on_stall(age_s)`` when no beat or write under ``cache_dirs``
    happened for ``timeout_s`` seconds; ``timeout_s <= 0`` disables it
    entirely."""

    def __init__(
        self,
        timeout_s: float,
        *,
        tag: str = "train",
        resume_hint: str = "relaunch with --resume 1",
        cache_dirs: Optional[Sequence[str]] = None,
        on_stall: Optional[Callable[[float], None]] = None,
        poll_s: Optional[float] = None,
    ):
        self.timeout_s = float(timeout_s)
        self.tag = tag
        self.resume_hint = resume_hint
        self.cache_dirs = list(cache_dirs or [])
        self._on_stall = on_stall or self._default_stall
        self._beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poll_s = poll_s if poll_s else max(
            1.0, min(30.0, self.timeout_s / 10.0)
        )
        self.fired = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Watchdog":
        if self.timeout_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="wedge-watchdog"
            )
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- the contract ------------------------------------------------------
    def beat(self):
        """Record forward progress (called once per train iteration)."""
        self._beat = time.monotonic()

    # -- internals ---------------------------------------------------------
    def _default_stall(self, age: float):
        print(
            f"[watchdog] {self.tag}: no progress for {age:.0f}s "
            f"(timeout {self.timeout_s:.0f}s) and no build-directory writes "
            f"— assuming a wedged device; exiting resumable "
            f"(exit code {EXIT_WEDGED}; {self.resume_hint})",
            flush=True,
        )
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_WEDGED)

    def _age(self) -> float:
        age = time.monotonic() - self._beat
        if self.cache_dirs and age > self.timeout_s:
            # a long build writes its library when it finishes and a
            # temporary file before: any recent write under the build
            # directories counts as progress
            cache_age = time.time() - _newest_mtime(self.cache_dirs)
            age = min(age, cache_age)
        return age

    def _run(self):
        while not self._stop.wait(self._poll_s):
            age = self._age()
            if age > self.timeout_s:
                self.fired = True
                self._on_stall(age)
                return
