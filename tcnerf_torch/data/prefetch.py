"""Host -> device input pipeline: batches synthesized in a background thread
and copied to the card while the current step runs (tcnerf/data/prefetch.py).

The producer thread draws every batch from the host iterator (so the data
generator's numpy RNG is used by that thread alone, in the plain loop's
order), copies it into pinned memory and starts the host-to-device copy on a
side CUDA stream, then records an event. The consumer makes its current
stream wait on that event before it hands the batch out, and marks the
batch's tensors as used on its stream so that the caching allocator does not
reuse them early. On the CPU the batches are the arrays themselves, as
`generators.to_device` gives them. An exception raised in the producer is
raised again in the consumer. Spans (`utils/profiling.py`): each batch the
producer makes is "tcnerf.feed.make" (in its thread, never a profiler
range: it launches no work of the consumer's), and the consumer's wait for
one "tcnerf.feed.wait".
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import span


def _host(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, x) for x in batch)
    return fn(batch)


def prefetch_to_device(batch_iter: Iterator, device: torch.device,
                       size: int = 2) -> Iterator:
    """Yield the batches of `batch_iter` (nested tuples of numpy arrays) as
    tensors on `device`, up to `size` batches ahead of the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err = []
    stop = threading.Event()
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def make(batch):
        if not cuda:
            return _map(_host, batch), None
        with torch.cuda.stream(stream):
            moved = _map(lambda a: _host(a).pin_memory().to(
                device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(stream)
        return moved, event

    def producer():
        try:
            batches = iter(batch_iter)
            while True:
                with span("tcnerf.feed.make", profile=False):
                    batch = next(batches, sentinel)
                    item = sentinel if batch is sentinel else make(batch)
                if item is sentinel or not put(item):
                    return
        except Exception as e:          # raised again on the consumer side
            err.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with span("tcnerf.feed.wait"):
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(event)
                    _map(lambda t: t.record_stream(current), batch)
            yield batch
    finally:
        stop.set()
        thread.join()


def prefetched_epochs(data_generator, n_epochs: Optional[int],
                      device: torch.device, size: int = 2) -> Iterator:
    """`n_epochs` epochs (endless when it is None) of a DataGenerator's
    (inputs, labels) batches, synthesized in the background and copied to
    `device` ahead of use."""
    def host_batches():
        epoch = 0
        while n_epochs is None or epoch < n_epochs:
            yield from data_generator.epoch()
            epoch += 1

    return prefetch_to_device(host_batches(), device, size=size)


class GeneratorFeeder:
    """Epochs of a DataGenerator's (inputs, labels) batches on `device`
    (the card unless the caller names another), `prefetch` batches ahead:
    `n_epochs` of them, or endless when it is None
    (tcnerf/data/prefetch.py `GeneratorFeeder`)."""

    def __init__(self, generator, n_epochs: Optional[int] = None,
                 prefetch: int = 2, device: Optional[torch.device] = None):
        self.generator = generator
        self.n_epochs = n_epochs
        self.prefetch = prefetch
        self.device = resolve_device(device)

    def __iter__(self):
        return prefetched_epochs(self.generator, self.n_epochs, self.device,
                                 self.prefetch)
