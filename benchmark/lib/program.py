"""The program's own spans and counters, read in the run's own process.

The port records spans and counters in memory
(`tcnerf_torch/utils/profiling.py`: `snapshot()`); each unit of work is
one root span, named by the cell's driver (`ROOTS`). A traced run's window
is the `len(run.records)` unit roots that come just before the traced
segment's `trace_units` roots, counted from the end of the recorder's
buffer; a span belongs to the window if it starts inside the interval from
the end of the unit root before the first of those (so that what the first
unit waited for counts) to the last one's end, whatever its thread.

The device-trace readers here sum the profiled segment's device time over
several of the port's ranges (`lib/trace.py` gives each kernel to the
innermost range open when it was launched, so a range's own time leaves
out the ranges nested in it).

Every reader returns None where there is nothing to read: a program that
keeps no recorder (an older commit), a buffer with too few roots, or one
that dropped spans.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

# the root span of a unit of work, by driver
ROOTS = {"grasp": "tcnerf.grasp", "train": "tcnerf.train.step",
         "view": "tcnerf.view"}


def _snapshot():
    try:
        from tcnerf_torch.utils import profiling
        return profiling.snapshot()
    except (ImportError, AttributeError):
        return None


def _unit_roots(spans) -> List:
    names = set(ROOTS.values())
    return sorted((s for s in spans if s.parent is None and s.name in names),
                  key=lambda s: s.start_ns)


def _clean_snapshot():
    snap = _snapshot()
    if snap is None or snap.counters.get("spans.dropped", 0) > 0:
        return None
    return snap


@dataclass
class Window:
    roots: List            # the window's unit roots, in order
    spans: List            # every span that starts inside the window

    def each_ms(self, name: str) -> List[float]:
        """Host time of each span `name` in the window, in ms."""
        return [(s.end_ns - s.start_ns) * 1e-6 for s in self.spans
                if s.name == name]

    def per_root_ms(self, name: str) -> List[float]:
        """Host time of the spans `name` under each root that has one,
        summed per root, in ms."""
        ids = {r.id for r in self.roots}
        total: Dict[int, float] = defaultdict(float)
        for s in self.spans:
            if s.name == name and s.root in ids:
                total[s.root] += (s.end_ns - s.start_ns) * 1e-6
        return list(total.values())

    def counter_changes(self, prefix: str) -> List[int]:
        """Per root, how much the counters named `prefix...` rose over it."""
        return [sum(v for k, v in (r.counters or {}).items()
                    if k.startswith(prefix)) for r in self.roots]


def window(run) -> Optional[Window]:
    snap = _clean_snapshot()
    root = ROOTS.get(run.traffic.get("driver"))
    if snap is None or root is None:
        return None
    roots = [r for r in _unit_roots(snap.spans) if r.name == root]
    n = len(run.records)
    after = int(run.traffic.get("trace_units", 2)) if run.trace else 0
    if n == 0 or len(roots) < n + after:
        return None
    first = len(roots) - after - n
    win = roots[first:first + n]
    a = roots[first - 1].end_ns if first else win[0].start_ns
    b = win[-1].end_ns
    return Window(win, [s for s in snap.spans if a <= s.start_ns <= b])


def in_setup_s(run, name: str) -> Optional[float]:
    """Host time of the spans `name` in the run's set-up, in s: those that
    start after the last unit root of an earlier run in this process and
    before the first unit root of this run's window (so its warm-up units
    count); 0 where there is none."""
    snap = _clean_snapshot()
    root = ROOTS.get(run.traffic.get("driver"))
    if snap is None or root is None:
        return None
    after = int(run.traffic.get("trace_units", 2)) if run.trace else 0
    measured = len(run.records) + after
    ours = int(run.traffic.get("warmup_units", 0)) + measured
    units = _unit_roots(snap.spans)
    mine = [r for r in units if r.name == root]
    if measured == 0 or len(mine) < ours:
        return None
    first, window_first = mine[-ours], mine[-measured]
    lo = max((r.end_ns for r in units if r.end_ns < first.start_ns),
             default=-1)
    return sum((s.end_ns - s.start_ns) * 1e-9 for s in snap.spans
               if s.name == name and lo < s.start_ns < window_first.start_ns)


def median(values: Sequence[float]) -> Optional[float]:
    return float(statistics.median(values)) if values else None


def mean(values: Sequence[float]) -> Optional[float]:
    return float(statistics.fmean(values)) if values else None


def ranges_ms(run, names: Sequence[str], prefixes: Sequence[str] = (),
              per: float = 1.0) -> Optional[float]:
    """Device time of the operations launched in the range `names[0]` and
    in the ranges `names[1:]` and `prefixes*` (those nested in it), per unit
    of the profiled segment and over `per`, in ms; None where the trace
    has no range `names[0]`."""
    t = run.trace
    if t is None or names[0] not in t.by_range_s or t.units == 0 or not per:
        return None
    s = sum(v for k, v in t.by_range_s.items()
            if k in names or k.startswith(tuple(prefixes)))
    return s * 1e3 / t.units / per
