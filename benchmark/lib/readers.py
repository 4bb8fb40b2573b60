"""What several metrics' readers share. Each returns None where the run
holds nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

from typing import Optional

from . import peaks, stats


def latencies_ms(run):
    return [r["latency_s"] * 1e3 for r in run.records if "latency_s" in r]


def per_unit_ms(run) -> Optional[float]:
    """The window's time per unit of work, in ms."""
    if not run.records:
        return None
    return run.window_s * 1e3 / len(run.records)


def device_idle(run) -> Optional[float]:
    """100 x (1 - device busy / wall) over the profiled segment."""
    t = run.trace
    if t is None or t.n_device_ops == 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run) -> Optional[float]:
    """100 x the least time the published peaks allow for one unit's
    model operations, at the precision the configuration states, over the
    window's time per unit."""
    flops = run.work.get("flops")
    unit = per_unit_ms(run)
    if not flops or not unit:
        return None
    return 100.0 * peaks.least_ms(flops) / unit


def span_mean_ms(run, name: str) -> Optional[float]:
    """A span's total time over the window's units, in ms."""
    ms = run.spans.ms(name)
    if not ms or not run.records:
        return None
    return sum(ms) / len(run.records)


def range_ms(run, name: str) -> Optional[float]:
    """Device time of the operations launched inside a profiler range, per
    unit of the profiled segment, in ms."""
    t = run.trace
    if t is None or name not in t.by_range_s or t.units == 0:
        return None
    return t.by_range_s[name] * 1e3 / t.units


def median(values) -> Optional[float]:
    return stats.median(values) if values else None
