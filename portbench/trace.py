"""A torch.profiler trace of some requests of the window, reduced to what
the per-layer metrics and the result's ``breakdown`` read.

The reduction follows ``sliceslice_tpu_torch/scripts/sweep_times.py``
``trace_share``: the device's activity (kernels, copies, fills) taken from
the trace's device events, overlaps merged, and device time summed by
name.  Here the window is the span of the traced requests, each marked by
a ``record_function`` of its own, and each stretch of that window in which
the device ran nothing is put down to what the host was doing at its
middle: the innermost host event of the requests' thread, or the request
itself (Python of the program between ops), or neither (the harness
between requests).
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Optional

#: The name of each traced request's mark.
REQUEST = "portbench.request"
IN_REQUEST = "host: Python inside a request"
BETWEEN = "host: harness between requests"


@dataclasses.dataclass
class Trace:
    requests: int
    window_s: float
    busy_s: float
    device_events: int
    #: device seconds by the device operation's full name.
    device_op_s: dict
    #: idle seconds by what the host was doing, longest first.
    idle_gaps: list

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose names match ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.device_op_s.items() if rx.search(name))

    def breakdown(self, top: int = 10) -> dict:
        ops: dict = {}
        for name, s in self.device_op_s.items():
            short = short_name(name)
            ops[short] = ops.get(short, 0.0) + s
        return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps[:top]]}


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()


class Tracer:
    """Starts and stops one profiler over requests marked by :meth:`mark`."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.running = False

    def start(self) -> None:
        self.prof.start()
        self.running = True

    def stop(self) -> None:
        if self.running:
            self.prof.stop()
            self.running = False

    @staticmethod
    def mark():
        from torch.profiler import record_function

        return record_function(REQUEST)

    def summary(self) -> Optional[Trace]:
        return summarize(self.prof.events())


def summarize(events) -> Optional[Trace]:
    from torch.autograd import DeviceType

    cpu, dev = [], []
    for e in events:
        (cpu if e.device_type == DeviceType.CPU else dev).append(e)
    reqs = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == REQUEST)
    if not reqs:
        return None
    thread = next(e.thread for e in cpu if e.name == REQUEST)
    lo, hi = reqs[0][0], max(b for _, b in reqs)
    # A device-side copy of a request's mark spans its kernels: not an op.
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi), e.name)
                   for e in dev if e.name != REQUEST
                   and e.time_range.end > lo and e.time_range.start < hi)
    by_name: dict = {}
    busy, end, gaps = 0.0, lo, []
    for a, b, name in spans:
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    if hi > end:
        gaps.append((end, hi))
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                  if e.thread == thread and e.name != REQUEST)
    idle: dict = {}
    for a, b in gaps:
        label = _host_at((a + b) / 2, host, reqs)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return Trace(len(reqs), (hi - lo) / 1e6, busy / 1e6, len(spans), by_name,
                 sorted(idle.items(), key=lambda kv: -kv[1]))


def _host_at(t: float, host: list, reqs: list, look_back: int = 512) -> str:
    """The innermost host event running at ``t`` (the latest-starting one
    that covers it), else whether ``t`` lies inside a request."""
    i = bisect.bisect_right(host, (t, float("inf"), "")) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    k = bisect.bisect_right(reqs, (t, float("inf"))) - 1
    return IN_REQUEST if k >= 0 and reqs[k][1] >= t else BETWEEN
