"""Tracing and timing (tcnerf/utils/profiling.py).

`trace(logdir)` records a `torch.profiler` trace of the host and, where
there is a card, of its kernels, and writes it into `logdir` as a Chrome
trace (`trace_<pid>_<ns>.json`, for Perfetto or chrome://tracing);
`benchmark(fn, *args)` is the mean wall seconds of a call after warm-up,
the card synchronised before each clock read; `timed(label)` times a scope.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the scope; on exit write its Chrome trace into `logdir`.
    Yields the `torch.profiler.profile`, whose `trace_path` names the file
    once the scope has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with prof:
        try:
            yield prof
        finally:
            _synchronize()
    prof.export_chrome_trace(prof.trace_path)


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2,
              **kwargs) -> float:
    """Mean wall seconds per call of `fn(*args, **kwargs)` over `iters`
    calls after `warmup` calls; the card (where one is in use) is
    synchronised before each clock read, so the calls' kernels are inside
    the time."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _synchronize()
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Wall-clock scope timer: `sink(label, seconds)`, or by default a line
    `<label>: <ms> ms` through `tcnerf_torch.utils.logging.logger`."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is None:
        from .logging import logger
        logger.info(f"{label}: {dt * 1000:.2f} ms")
    else:
        sink(label, dt)
