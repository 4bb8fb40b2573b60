"""Fused residual-MLP chain over rows: wrapper of the CUDA kernel
`csrc/resmlp.cu` (the port of tcnerf/ops/pallas/resmlp.py:137 `resmlp_rows`)
and its plain PyTorch version.

Flat weights follow the JAX package's layout: `[w0 [in, out], b0]` unless
`skip_input`, then `[wA, bA, wB, bB] * n_blocks` (each `[128, 128]` /
`[128]`), then `[w_r [128, out], b_r]` if `readout`.

Numerics (both versions, as `chain_math`): every product casts its input to
the weight dtype and accumulates in f32, then adds the bias in f32. With
`fast`, each layer output drops back to the weight dtype (the bf16 serving
stream); otherwise the stream stays f32. The output has x's dtype.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .cuda_lib import KernelLib, ptr, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
RESMLP = KernelLib("resmlp.cu", {"resmlp_launch": [
    _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P]})

HIDDEN = 128
MAX_OUT = 8


def _act(activation: str):
    if activation == "relu":
        return torch.relu
    if activation == "elu":
        return torch.nn.functional.elu
    raise ValueError(f"activation {activation} not supported")


def _mm(r, w, b, fast: bool):
    out = r.to(w.dtype).float() @ w.float() + b.float()
    return out.to(w.dtype) if fast else out


def resmlp_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 n_blocks: int, readout: bool = False,
                 activation: str = "relu", skip_input: bool = False,
                 fast: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the chain. x: [N, D_in] -> [N, H or out]."""
    act = _act(activation)
    if skip_input:
        h, idx = (x if fast else x.float()), 0
    else:
        h, idx = _mm(x, weights[0], weights[1], fast), 2
    for _ in range(n_blocks):
        wa, ba, wb, bb = weights[idx:idx + 4]
        idx += 4
        r = _mm(act(h), wa, ba, fast)
        r = _mm(act(r), wb, bb, fast)
        h = h + r
    if readout:
        h = _mm(torch.relu(h), weights[idx], weights[idx + 1], fast)
    return h.to(x.dtype)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"resmlp_rows: {msg}")


def pack_blocks(blocks: Sequence[torch.Tensor], n_blocks: int,
                device: torch.device):
    """Block weights -> ([2n, 128, 128] bf16 in [out][in], [2n, 128] f32)."""
    if n_blocks == 0:      # the kernel never reads them; keep pointers valid
        return (torch.zeros((1, HIDDEN, HIDDEN), dtype=torch.bfloat16,
                            device=device),
                torch.zeros((1, HIDDEN), dtype=torch.float32, device=device))
    ws = [blocks[4 * i + j].t() for i in range(n_blocks) for j in (0, 2)]
    bs = [blocks[4 * i + j] for i in range(n_blocks) for j in (1, 3)]
    return torch.stack(ws).contiguous(), torch.stack(bs).float().contiguous()


def resmlp_rows(x: torch.Tensor, weights: Sequence[torch.Tensor],
                n_blocks: int, readout: bool = False,
                activation: str = "relu", skip_input: bool = False,
                fast: bool = False) -> torch.Tensor:
    """The fused chain over rows. A CPU tensor takes `resmlp_plain`; a CUDA
    tensor launches the kernel (bf16 weights, hidden 128, readout <= 8)."""
    if x.device.type == "cpu":
        return resmlp_plain(x, weights, n_blocks, readout, activation,
                            skip_input, fast)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.dim() == 2 and x.is_contiguous(), "x must be contiguous [N, D]")
    _check(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    _check(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype}")
    _act(activation)
    n_w = (0 if skip_input else 2) + 4 * n_blocks + (2 if readout else 0)
    _check(len(weights) == n_w, f"expected {n_w} weights, got {len(weights)}")
    for w in weights:
        _check(w.device == x.device and w.dtype == torch.bfloat16,
               "weights must be bf16 on x's device")
    idx = 0
    if skip_input:
        _check(x.shape[1] == HIDDEN, f"skip_input needs width {HIDDEN}")
        w0t = b0 = None
        d_in = 0
    else:
        w0, b0 = weights[0], weights[1].float().contiguous()
        _check(tuple(w0.shape) == (x.shape[1], HIDDEN), "w0 must be [D_in, 128]")
        d_in, idx = x.shape[1], 2
        d_pad = -(-d_in // HIDDEN) * HIDDEN
        w0t = torch.zeros((HIDDEN, d_pad), dtype=torch.bfloat16,
                          device=x.device)
        w0t[:, :d_in] = w0.t()
    blocks = weights[idx:idx + 4 * n_blocks]
    for i, w in enumerate(blocks):
        _check(tuple(w.shape) == ((HIDDEN, HIDDEN) if i % 2 == 0 else (HIDDEN,)),
               "block weights must be [128, 128] / [128]")
    wpack, bpack = pack_blocks(blocks, n_blocks, x.device)
    if readout:
        wr, br = weights[-2], weights[-1]
        out_dim = wr.shape[1]
        _check(wr.shape[0] == HIDDEN and 0 < out_dim <= MAX_OUT,
               f"readout must be [128, <= {MAX_OUT}]")
        wro, bro = wr.t().contiguous(), br.float().contiguous()
    else:
        out_dim, wro, bro = 0, None, None
    n = x.shape[0]
    out = torch.empty((n, out_dim or HIDDEN), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    round_stream = fast and (not skip_input or x.dtype == torch.bfloat16)
    RESMLP.call("resmlp_launch", ptr(x), ptr(out),
                int(x.dtype == torch.bfloat16), ptr(w0t), ptr(b0), d_in,
                ptr(wpack), ptr(bpack), n_blocks, ptr(wro), ptr(bro), out_dim,
                n, int(fast), int(round_stream), int(activation == "elu"),
                stream_handle(x.device))
    RESMLP.counts["resmlp_rows"] += 1
    return out
