"""The profiled segment of a traced run and what is read from its trace.

`profiled(fn, n)` runs `fn` n times under `torch.profiler` (CPU and CUDA
activities), writes the Chrome trace to a temporary file, reads it and
deletes it. From the trace:

  * busy: the union of the device's operation intervals (kernels, copies,
    sets), over the segment's host-clock wall;
  * by range: each device operation is given to the `record_function`
    range that was open on the host when the runtime call that launched it
    was made (matched by correlation id), so kernels that `ctypes` launches
    count too, which the profiler's own tables leave out of the ranges;
  * the operations that took most time and the longest idle gaps, each
    with the host range open when the gap began.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float                      # host wall of the profiled segment
    units: int                           # calls of fn inside it
    busy_s: float                        # union of device intervals
    by_range_s: Dict[str, float] = field(default_factory=dict)
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    n_device_ops: int = 0


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarize(events: List[dict], window_s: float, units: int
              ) -> TraceSummary:
    """Read Chrome-trace events (the `traceEvents` list; times in us)."""
    dev, launches, ranges = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat == "user_annotation":
            ranges.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e["name"]))
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in dev]
    busy_us = _union(intervals)

    def range_at(ts: float) -> str:
        """The innermost range open at host time ts, or ''."""
        inside = [(b - a, name) for a, b, name in ranges if a <= ts <= b]
        return min(inside)[1] if inside else ""

    by_range: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        dur = float(e["dur"]) * 1e-6
        by_name[e["name"]] += dur
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            name = range_at(launches[corr])
            if name:
                by_range[name] += dur
    # idle gaps between device operations, named by the host range open
    # when the gap began
    gaps = []
    last_end = None
    for a, b in sorted(intervals):
        if last_end is not None and a > last_end:
            gaps.append((a - last_end, last_end))
        last_end = b if last_end is None else max(last_end, b)
    gaps.sort(reverse=True)
    idle = [(range_at(at) or "outside any range", g * 1e-6)
            for g, at in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s, units, busy_us * 1e-6, dict(by_range),
                        top, idle, len(dev))


def profiled(fn: Callable[[int], object], n: int, first: int = 0
             ) -> TraceSummary:
    """Run fn(first), ..., fn(first + n - 1) under the profiler and read the
    trace. The segment's wall starts and ends with the card synchronised."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(first, first + n):
            fn(i)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarize(events, wall, n)
