"""The reduction from a ``torch.profiler`` trace to device time: busy time
is the union of the kernel, memcpy and memset intervals (user annotations,
which span kernels already counted, are left out), the activities are
those intervals counted, and the idle gaps are what lies between them,
named by the host op that was running when each began.  The arithmetic is
a copy of the port's ``profile_step.py``; this copy is the yardstick."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

# a kernel's template arguments run to kilobytes: the breakdown keeps the head
NAME_CHARS = 160


class DeviceTrace(NamedTuple):
    spans: List[Tuple[float, float]]  # device activity intervals, us, sorted
    kernels: Dict[str, Tuple[float, int]]  # name -> (device us, count)
    host: List[Tuple[float, float, str]]  # host op intervals, us
    window_us: Tuple[float, float]  # first activity start, last end

    @property
    def busy_us(self) -> float:
        busy, cur = 0.0, None
        for s, e in self.spans:
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """Seconds of idle device time by the host op running at each gap's
        start (the innermost one), the ``top`` largest."""
        gaps, end = [], None
        for s, e in self.spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        by_name: Dict[str, float] = defaultdict(float)
        host, stack, hi = sorted(self.host), [], 0
        for g0, g1 in gaps:
            # host ops nest: the innermost open at g0 is the last pushed
            while hi < len(host) and host[hi][0] <= g0:
                while stack and stack[-1][1] < host[hi][0]:
                    stack.pop()
                stack.append(host[hi])
                hi += 1
            while stack and stack[-1][1] < g0:
                stack.pop()
            by_name[stack[-1][2][:NAME_CHARS] if stack else "host"] += (g1 - g0) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    def top_kernels(self, top: int = 10) -> List[Tuple[str, float]]:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return [(name[:NAME_CHARS], us / 1e6) for name, (us, _) in rows]


def read(prof) -> DeviceTrace:
    """The device activities and host ops of a finished profiler."""
    spans, host = [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.is_user_annotation:
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.device_type.name == "CUDA":
            spans.append((start, end))
            k = kernels[e.name]
            k[0] += end - start
            k[1] += 1
        else:
            host.append((start, end, e.name))
    spans.sort()
    window = (spans[0][0], max(e for _, e in spans)) if spans else (0.0, 0.0)
    return DeviceTrace(spans, {k: (v[0], int(v[1])) for k, v in kernels.items()}, host, window)
