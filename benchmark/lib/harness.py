"""One run of one cell: set-up, the measured window, the traced segment,
the check against the reference, the metrics, and the result line.

A driver (`drivers/<name>.py`, named by the traffic mix) provides:

    setup(ctx) -> state        program, weights, inputs; warm every shape
    unit(state, i) -> dict     one request or step; its record
    finish(state) -> None      free the program, keep what `check` needs
    check(state) -> dict       {number name: value} against the reference
    cleanup(state) -> None     (optional) remove what set-up wrote
    work(state) -> dict        the arithmetic of one unit (lib/work.py)

`ctx` carries the configuration, the traffic parameters, the seed, the
device, and, for the readings and the tests, `faults` (names of faults to
plant in the timed path) and `control` (the cell file's `control`: the
driver's parameters that put the reference in the nearest lower precision
in the program's place; empty in a benchmark run).
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from . import spans as spans_mod
from . import trace as trace_mod


@dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    faults: frozenset = frozenset()
    control: dict = field(default_factory=dict)


@dataclass
class RunData:
    """What a metric's reader reads."""
    cell: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    records: List[dict]
    spans: spans_mod.Spans
    work: dict
    trace: Optional[trace_mod.TraceSummary] = None


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]
    breakdown: Optional[dict] = None
    info: Dict[str, float] = field(default_factory=dict)


def window(driver, state, seconds: float, first: int
           ) -> Tuple[float, List[dict]]:
    """Units from `first` on until `seconds` of them have passed; a unit
    that reports `service_s` counts that, else the window is wall time."""
    records, busy = [], 0.0
    t0 = time.perf_counter()
    i = first
    while True:
        rec = driver.unit(state, i)
        records.append(rec)
        i += 1
        busy = (busy + rec["service_s"] if "service_s" in rec
                else time.perf_counter() - t0)
        if busy >= seconds:
            return busy, records


def spans_for(metrics) -> Dict[str, str]:
    targets: Dict[str, str] = {}
    for m in metrics:
        targets.update(getattr(m.reader, "SPANS", {}))
    return targets


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             faults=frozenset(), control: bool = False) -> Result:
    """One run. With `control`, the check holds the control (the
    reference in the nearest lower precision) in the program's place
    against the limits: such a run has to come out not correct."""
    driver = cell.driver()
    ctx = Context(cell.config, cell.traffic, seed, device, frozenset(faults),
                  dict(cell.checks["control"]) if control else {})
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    spans = spans_mod.Spans(cuda)
    warm = int(cell.traffic.get("warmup_units", 0))
    if trace:
        with spans_mod.wrapped(spans_for(cell.per_layer), spans):
            window_s, records = window(driver, state, seconds, warm)
        n = int(cell.traffic.get("trace_units", 2))
        summary = trace_mod.profiled(lambda i: driver.unit(state, i), n,
                                     warm + len(records))
    else:
        window_s, records = window(driver, state, seconds, warm)
        summary = None
    if cuda:
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    data = RunData(cell.name, cell.config, cell.traffic, setup_s, window_s,
                   records, spans, driver.work(state) if trace else {},
                   summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(data)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {m.name} read {value}")
            metrics[m.name] = {"value": float(value), "unit": m.spec["unit"]}
    failed = sum(1 for r in records if r.get("failed"))
    driver.finish(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    try:
        numbers = driver.check(state)
    finally:
        if hasattr(driver, "cleanup"):
            driver.cleanup(state)
    limits = cell.checks["limits"]
    checks, info = {}, {}
    for name, value in numbers.items():
        if name in limits:
            checks[name] = {"value": float(value), "limit": limits[name]}
        else:
            info[name] = float(value)
    missing = sorted(set(limits) - set(numbers))
    correct = (not missing and failed == 0 and bool(checks)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        breakdown = {"device_ops": [[k, v] for k, v in summary.top_ops],
                     "idle_gaps": [[k, v] for k, v in summary.idle_gaps]}
    if missing:
        info["missing_checks"] = float(len(missing))
    return Result(correct, len(records), failed, metrics, dev, checks,
                  breakdown, info)


def emit(result: Result, out=None, err=None) -> None:
    out = out or sys.stdout
    err = err or sys.stderr
    for name, value in result.info.items():
        print(f"info {name}: {value!r}", file=err)
    print(f"correct: {result.correct}", file=err)
    for name, c in result.checks.items():
        ok = c["value"] <= c["limit"]
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=err)
    err.flush()
    line = {"correct": result.correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": result.metrics,
            "device": result.device}
    if result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = result.checks
    print(json.dumps(line), file=out)
    out.flush()


def plant(owner, attr: str, tag: str, make) -> None:
    """Replace `owner.attr` by `make(original)`, once: a fault already
    planted there (by `tag`) is left as it is. For the faults the tests
    plant in the timed path."""
    current = getattr(owner, attr)
    if getattr(current, "_bench_fault", None) == tag:
        return
    replacement = make(current)
    replacement._bench_fault = tag
    setattr(owner, attr, replacement)
