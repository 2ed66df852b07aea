"""Spans and counters at the port's layer boundaries, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` runs; there is no flag of
its own.  Off, ``span(name)`` reads one flag and returns a shared null
context, and ``count``/``count_shape`` return at once: nothing is
allocated, launched or synchronised.  On:

- ``span(name)`` opens a ``torch._C._profiler._RecordFunctionFast``, a host
  event of the same Kineto trace as the kernels, on its clock (not a user
  annotation, as ``torch.profiler.record_function``'s are).  Its parent is
  the span open around it on the thread.  The profiler keeps the spans and
  writes them out; this module keeps nothing of them.
- ``count(name, value, scale)`` adds ``value * scale`` to a counter.  A
  tensor ``value`` (0-d, computed by the program anyway) is kept detached,
  by reference, and read only by ``take_counts``: counting launches no
  kernel and waits for nothing.
- ``count_shape(name, shape)`` appends one call's shape tuple to a list.

``take_counts()`` returns the counters' sums as floats and the shape lists,
and clears them.  Names are fixed strings: spans under ``tftorch.``
(``tftorch.train.step``, ``tftorch.serve.view``, ...), counters as
``render.rays``; README's profiling section lists them.
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from typing import Dict, List, Tuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
# name -> [(value, scale)]; name -> [shape tuple]
_counts: Dict[str, list] = defaultdict(list)
_shapes: Dict[str, List[Tuple[int, ...]]] = defaultdict(list)


def enabled() -> bool:
    """Whether a profiler runs: spans and counters record only then."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context that marks ``name`` in the profiler's trace (a shared null
    context when no profiler runs)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return torch._C._profiler._RecordFunctionFast(name)


def count(name: str, value: Union[int, float, torch.Tensor], scale: float = 1.0) -> None:
    """Add ``value * scale`` to counter ``name``; a tensor is summed when
    read."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach()
    with _lock:
        _counts[name].append((value, scale))


def count_shape(name: str, shape: Tuple[int, ...]) -> None:
    """Append one call's ``shape`` to the list ``name``."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _lock:
        _shapes[name].append(tuple(shape))


def take_counts() -> Dict[str, Union[float, List[Tuple[int, ...]]]]:
    """The counters' sums (floats) and the shape lists, by name; clears
    them.  Reads the kept tensors, so it waits for the device."""
    with _lock:
        counts, shapes = dict(_counts), dict(_shapes)
        _counts.clear()
        _shapes.clear()
    out: Dict[str, Union[float, List[Tuple[int, ...]]]] = {
        name: float(sum(float(v) * s for v, s in items)) for name, items in counts.items()}
    out.update(shapes)
    return out
