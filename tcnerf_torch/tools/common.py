"""What the gather probes share: the device line, timing, the bound and the
probe report."""

from __future__ import annotations

import argparse
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.gather import GATHER, ONEHOT_TILE, onehot_tile_blocks

# published peaks of one H100 SXM (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12        # f32 FFMA, outside the tensor cores
PEAK_BYTES = 3.35e12


@dataclass
class KernelCase:
    """One TPU kernel's probe at the probe's shapes: the port's kernel call,
    its plain version, the one PyTorch call that computes the same function,
    and the work the bound counts. A one-hot product also names its dense
    operations and those the kernel executes on these indices, which the
    bound does not count: the function is a gather."""
    k: str                     # TPU kernel number in PERF.md's table
    probe: str                 # probe letter in the tool's output
    kernel: str                # GATHER.counts key of the kernel
    mode: str
    call: Callable
    plain: Callable
    library: Callable
    flops: float
    nbytes: float
    product: Optional[Tuple[float, float]] = None   # (dense, executed)


def onehot_product(win: torch.Tensor, idx: torch.Tensor
                   ) -> Tuple[float, float]:
    """(dense, executed) operations of onehot(idx) @ win: the dense product
    over the whole window, and the one-hot kernel's, over the k16 blocks
    each of its tiles hits."""
    cols = win.shape[1]
    dense = 2. * idx.numel() * win.shape[0] * cols
    blocks = onehot_tile_blocks(idx, win.shape[0])
    return dense, 2. * blocks * ONEHOT_TILE * 16 * cols


def dtype_name(t: torch.Tensor) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "f32"}[t.dtype]


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def to_torch(a: np.ndarray, dtype: torch.dtype, device: torch.device
             ) -> torch.Tensor:
    """numpy -> torch on `device`; floats are cast to f32 on the host,
    which halves the bytes copied to the card."""
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dtype)


def base_parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; cuda raises without a card")
    p.add_argument("--seed", type=int, default=0)
    return p


def device_line(device: torch.device) -> str:
    """The card's `nvidia-smi` name and power limit; on the CPU, a line
    saying that the times below are host times."""
    if device.type != "cuda":
        return (f"device {device}: no card; the times below are host times "
                f"of the plain versions, not device metrics")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """Least time on the card: max(operations at `peak`, the bf16 peak by
    default, bytes at the memory rate), in ms, and which of the two bounds
    it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn: Callable, device: torch.device, iters: int,
            warmup: int = 1) -> float:
    """ms per call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable, device: torch.device, calls: int = 20,
             replays: int = 5) -> float:
    """ms per call on the card alone: `calls` back-to-back calls captured in
    one CUDA graph, replayed `replays` times between CUDA events. For a
    kernel shorter than its wrapper's host work (checks, allocation, the
    launch itself), `time_ms` reads the host's launch rate instead. On the
    CPU, `time_ms`."""
    if device.type != "cuda":
        return time_ms(fn, device, calls)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):       # warm up off the default stream
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def random_chain(gen: torch.Generator, n_blocks: int, d_in: Optional[int],
                 out_dim: int, device) -> list:
    """Flat chain weights ([in, out] layout) in bf16, glorot-like scale: an
    input Dense if d_in, n_blocks residual blocks, a readout if out_dim."""
    HID = 128

    def w(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    flat = [] if d_in is None else [w((d_in, HID), d_in ** -0.5),
                                    w((HID,), 0.1)]
    for _ in range(n_blocks):
        flat += [w((HID, HID), HID ** -0.5), w((HID,), 0.1),
                 w((HID, HID), HID ** -0.5), w((HID,), 0.1)]
    if out_dim:
        flat += [w((HID, out_dim), HID ** -0.5), w((out_dim,), 0.1)]
    return flat


def check_case(case: KernelCase) -> float:
    """The case's kernel call against its plain version, bit for bit."""
    return check_equal(f"{case.k} {case.probe}", case.call(), case.plain())


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Bit-equality (a gather moves bits); returns max |got - want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{list(got.shape)} vs "
                             f"{want.dtype}{list(want.shape)}")
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel output differs from its plain "
                             f"version (max abs err {err})")
    return err


def probe(name: str, fn: Callable, n: int, device: torch.device, iters: int,
          kernel: Optional[str] = None, flops: float = 0.,
          nbytes: float = 0., per_call: int = 1,
          product: Optional[Tuple[float, float]] = None) -> Dict:
    """Time one probe and print its line: ms per op, ns per row and, for a
    kernel probe, the bound and the launches of `kernel` during the probe.
    `per_call` ops run inside one call of fn. `product` = (dense, executed)
    operations of a one-hot product, printed beside the bound."""
    before = GATHER.counts[kernel] if kernel else 0
    ms = time_ms(fn, device, iters) / per_call
    res = dict(ms=ms, ns_per_row=ms * 1e6 / n)
    line = f"{name:34s} {ms:9.4f} ms  {res['ns_per_row']:8.4f} ns/row"
    if kernel:
        b, by = bound_ms(flops, nbytes)
        res.update(kernel=kernel, launches=GATHER.counts[kernel] - before,
                   bound_ms=b, bound_by=by, bytes_ms=bound_ms(0., nbytes)[0])
        line += f"  bound {b:.4f} ms by {by}"
        if by == "operations":
            line += f" (bytes alone {res['bytes_ms']:.4f} ms)"
        if device.type == "cuda":
            line += f" ({ms / b:.2f}x)"
        if product:
            res.update(dense_flops=product[0], executed_flops=product[1])
            line += (f"; product dense {product[0]:.4g} ops, executed "
                     f"{product[1]:.4g}")
    print(f"{line} [{device.type}]", flush=True)
    return res
