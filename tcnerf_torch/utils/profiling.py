"""Tracing and timing (tcnerf/utils/profiling.py).

`trace(logdir)` records a `torch.profiler` trace of the host and, where
there is a card, of its kernels, and writes it into `logdir` as a Chrome
trace (`trace_<pid>_<ns>.json`, for Perfetto or chrome://tracing);
`benchmark(fn, *args)` is the mean wall seconds of a call after warm-up,
the card synchronised before each clock read; `timed(label)` times a scope.

The program's own spans and counters:

    with span("tcnerf.view"):            # or @span("tcnerf.view")
        ...
    snapshot().spans, snapshot().counters; reset()

A span always records its host-clock start and end
(`time.perf_counter_ns`), its parent and root span (from a stack kept per
thread) and its thread into one bounded buffer per process
(`SPAN_CAPACITY` spans; past it a span is dropped and the counter
`spans.dropped` raised). A root span also keeps the read counters (below)
as they stood at its start and end, and `snapshot()` gives it how much
each changed. It never touches the card: no CUDA event, no sync. Only while a
`torch.profiler` is recording does a span also enter
`torch.profiler.record_function(name)`, so that it is a range in the same
Chrome trace as the kernels; `span(name, profile=False)` never does, and
keeps no counters as a root (for a thread that launches no work of its
own, and for host work that may open inside a measured range). The
counters are the process's, not a thread's. The launch counts of the CUDA
libraries (`ops/cuda_lib.py` `KernelLib.counts`) are read where they are
kept, as `kernels.<library>.<symbol>`. Nothing is written to disk.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function


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


# ------------------------------------------------------------------ spans

SPAN_CAPACITY = 65_536


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]              # None for a root span
    root: int                          # the root span's id (its own if root)
    thread: int                        # threading.get_ident()
    start_ns: int                      # time.perf_counter_ns()
    end_ns: int
    counters: Optional[Dict[str, int]]  # a root's counter changes, else None


class Snapshot(NamedTuple):
    spans: List[Span]                  # in the order they ended
    counters: Dict[str, int]


class Recorder:
    """The process's spans and counters (`RECORDER`; the module's functions
    use it)."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self._spans: list = []
        self._counters: collections.Counter = collections.Counter()
        self._sources: List[tuple] = []       # (prefix, a mapping of counts)
        self._maps: list = []                 # the mappings alone
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def read_counts(self, prefix: str, counts: Mapping[str, int]) -> None:
        """Read `counts`, which its owner keeps raising, as the counters
        `<prefix>.<key>` (no second tally is kept)."""
        self._sources.append((prefix, counts))
        self._maps.append(counts)

    def counter_values(self) -> Dict[str, int]:
        out = dict(self._counters)
        for prefix, counts in self._sources:
            out.update((f"{prefix}.{k}", v) for k, v in list(counts.items()))
        return out

    def _raw(self) -> list:
        """The read counts as they stand, unnamed (plain dict copies, the
        cheapest): what a root span keeps at its start and end; `snapshot`
        takes the difference."""
        return list(map(dict.copy, self._maps))

    def _changed(self, before: list, after: list) -> Dict[str, int]:
        """The named counters that rose from `before` to `after`."""
        out = {}
        for (prefix, _), was, new in zip(self._sources, before, after):
            for k, v in new.items():
                if v != was.get(k, 0):
                    out[f"{prefix}.{k}"] = v - was.get(k, 0)
        return out

    def add(self, record: tuple) -> None:
        # an append is atomic; two threads past the check together may
        # put one span more than `capacity` in
        if len(self._spans) < self.capacity:
            self._spans.append(record)
        else:
            with self._lock:
                self._counters["spans.dropped"] += 1

    def snapshot(self) -> Snapshot:
        with self._lock:
            records = list(self._spans)
        spans = [Span(*r[:7], None if r[7] is None
                      else self._changed(*r[7])) for r in records]
        return Snapshot(spans, self.counter_values())

    def reset(self) -> None:
        """Forget the spans and this recorder's own counters (the libraries'
        launch counts are theirs, and stay)."""
        with self._lock:
            self._spans.clear()
            self._counters.clear()


RECORDER = Recorder()
_now = time.perf_counter_ns
_ident = threading.get_ident


class span:
    """A span named `name` around a `with` block or, as a decorator, around
    each call of a function. `.start_ns` and `.end_ns` (perf_counter_ns)
    are set on entry and exit, `.seconds` after it. With `profile=False`
    the span is never a profiler range and, as a root, keeps no counters:
    for a thread that launches no work of its own, since the counters are
    the process's and would show the launching thread's work."""

    __slots__ = ("name", "profile", "id", "root", "start_ns", "end_ns",
                 "_parent", "_before", "_range")

    def __init__(self, name: str, profile: bool = True):
        self.name = name
        self.profile = profile

    def __enter__(self) -> "span":
        stack = RECORDER.stack()
        self.id = next(RECORDER._ids)
        if stack:
            self._parent, self.root = stack[-1].id, stack[-1].root
            self._before = None
        else:
            self._parent, self.root = None, self.id
            self._before = RECORDER._raw() if self.profile else None
        self._range = None
        if self.profile and _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = _now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _now()
        RECORDER.stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        counters = None
        if self._before is not None:
            counters = (self._before, RECORDER._raw())
            self._before = None
        RECORDER.add((self.name, self.id, self._parent, self.root, _ident(),
                      self.start_ns, self.end_ns, counters))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __call__(self, fn: Callable) -> Callable:
        name, profile = self.name, self.profile

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, profile):
                return fn(*args, **kwargs)
        return spanned


def snapshot() -> Snapshot:
    return RECORDER.snapshot()


def reset() -> None:
    RECORDER.reset()
