"""Spans around the program's own functions, from the benchmark's side.

`wrapped({"grasp.encode":
"tcnerf_torch.models.grasp:GraspEBM.compute_features"})` replaces each named function for the block's duration by one that records
a pair of CUDA events around the call (on the CPU: host clock readings);
`Spans.ms(name)` reads them afterwards. A name that no longer resolves
raises, so a rename in the program fails the run instead of reading 0.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time
from collections import defaultdict
from typing import Dict, List

import torch


def resolve(target: str):
    """'package.module:Class.attr' -> (owner object, attribute name)."""
    module_name, _, qual = target.partition(":")
    if not qual:
        raise ValueError(f"span target {target!r} lacks ':'")
    owner = importlib.import_module(module_name)
    parts = qual.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part)
    if not hasattr(owner, parts[-1]):
        raise AttributeError(f"span target {target!r} does not exist")
    return owner, parts[-1]


class Spans:
    """Recorded (start, end) pairs per span name."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.pairs: Dict[str, List] = defaultdict(list)

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, name: str, t0) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs[name].append((t0, ev))
        else:
            self.pairs[name].append((t0, time.perf_counter()))

    def ms(self, name: str) -> List[float]:
        """Each recorded span of `name` in ms (synchronises the card)."""
        if self.cuda and self.pairs.get(name):
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.pairs[name]]
        return [(b - a) * 1e3 for a, b in self.pairs.get(name, ())]


@contextlib.contextmanager
def wrapped(targets: Dict[str, str], spans: Spans):
    """Record a span named by each key around every call of the function
    its value names, for the block's duration."""
    saved = []
    try:
        for name, target in targets.items():
            owner, attr = resolve(target)
            fn = getattr(owner, attr)
            saved.append((owner, attr, owner.__dict__.get(attr, fn)))

            def make(fn, name):
                @functools.wraps(fn)
                def wrapper(*args, **kwargs):
                    t0 = spans.start()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        spans.stop(name, t0)
                return wrapper

            setattr(owner, attr, make(fn, name))
        yield spans
    finally:
        for owner, attr, original in reversed(saved):
            setattr(owner, attr, original)
