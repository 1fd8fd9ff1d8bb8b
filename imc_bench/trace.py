"""A traced slice of requests: ``torch.profiler``'s record of what ran on
the card, reduced to intervals on one timeline.

The slice runs inside one ``record_function`` range; that range's host
interval is the traced window.  Device operations are the trace's CUDA
events (kernels, copies, sets), the profiler's own annotation of the range
left out.  Timestamps are in seconds on the profiler's clock, which holds
host and device events alike.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from . import stats

SLICE = "imc_bench.slice"
COPY_PREFIXES = ("Memcpy", "Memset")
NAME_CHARS = 120


class Op(NamedTuple):
    name: str
    start: float
    end: float


class Traced(NamedTuple):
    ops: List[Op]            # device operations
    host: List[Op]           # host operations (aten ops, CUDA runtime calls)
    window: Tuple[float, float]
    requests: int
    frames: int

    @property
    def seconds(self) -> float:
        return self.window[1] - self.window[0]


def record(fn: Callable[[], int], frames_per_request: int) -> Traced:
    """Run ``fn()``, which returns how many requests it sent, under
    ``torch.profiler``, and read the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(SLICE):
            requests = fn()
    ops, host, window = [], [], None
    for e in prof.events():
        op = Op(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.name == SLICE:
            if e.device_type == torch.autograd.DeviceType.CPU:
                window = (op.start, op.end)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append(op)
        else:
            host.append(op)
    if window is None:
        raise RuntimeError("the profiler recorded no slice range")
    return Traced(ops, host, window, requests, requests * frames_per_request)


def is_kernel(op: Op) -> bool:
    return not op.name.startswith(COPY_PREFIXES)


def busy_seconds(t: Traced) -> float:
    """Seconds of the window in which some device operation ran."""
    return stats.covered(((o.start, o.end) for o in t.ops), t.window)


def device_seconds(t: Traced, keep: Callable[[Op], bool]) -> float:
    """Summed durations of the device operations ``keep`` selects, inside
    the window."""
    lo, hi = t.window
    return sum(min(o.end, hi) - max(o.start, lo) for o in t.ops
               if keep(o) and o.end > lo and o.start < hi)


def _host_at(host: List[Op], starts: List[float], at: float) -> str:
    """The innermost host operation running at ``at``."""
    i = bisect.bisect_right(starts, at)
    while i > 0:
        i -= 1
        if host[i].end >= at:
            return host[i].name
    return "python"


def breakdown(t: Traced, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    device's idle time inside the window, summed by the host operation
    running at each gap's middle: ``top`` of each, in seconds."""
    by_op: Dict[str, float] = defaultdict(float)
    for o in t.ops:
        by_op[o.name[:NAME_CHARS]] += o.end - o.start
    host = sorted(t.host, key=lambda o: o.start)
    starts = [o.start for o in host]
    by_host: Dict[str, float] = defaultdict(float)
    for s, e in stats.gaps(((o.start, o.end) for o in t.ops), t.window):
        by_host["host: " + _host_at(host, starts, (s + e) / 2)[:NAME_CHARS]] += e - s

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
