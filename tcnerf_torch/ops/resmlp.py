"""Fused residual-MLP chain over rows: wrapper of the CUDA kernel
`csrc/resmlp.cu` (the port of tcnerf/ops/pallas/resmlp.py:137 `resmlp_rows`)
and its plain PyTorch version.

Flat weights follow the JAX package's layout: `[w0 [in, out], b0]` unless
`skip_input`, then `[wA, bA, wB, bB] * n_blocks` (each `[128, 128]` /
`[128]`), then `[w_r [128, out], b_r]` if `readout`.

Numerics (both versions, as `chain_math`): every product casts its input to
the weight dtype and accumulates in f32, then adds the bias in f32 (the
plain version accumulates f64 weights in f64: the CPU tests compare the
whole model's f64 gradients with the JAX package's, and on the CPU the
model's `use_pallas` chain is this function, so it must keep f64). With
`fast`, each layer output drops back to the weight dtype (the bf16 serving
stream); otherwise the stream stays f32. The output has x's dtype.

The kernel streams its layers from one packed tensor (`pack_chain`, a
`ChainPack`): per 128x128 layer the bf16 `[out][in]` weights in the
canonical K-major 128-byte-swizzled layout that wgmma reads from shared
memory (`swizzle_index`), then the layer's f32 bias. Callers on a hot path
build the pack once and pass it; without one the wrapper packs per call.

`resmlp_rows_diff` (K1', the port of tcnerf/ops/pallas/resmlp.py:180) is the
differentiable chain: the kernel forward, and a backward that recomputes
the chain through `resmlp_plain` and differentiates that, as the JAX
custom_vjp does through `resmlp_reference`. No backward kernel exists on
either side. In training the forward takes f32 rows in and out, so bytes
bound it (0.040 ms at a chunk's 131,072 rows on an H100; it runs in 0.066
ms there, timed as a CUDA graph of launches); the plain backward, f32
GEMMs, takes about 4.5 ms (PERF.md, measured by chip_smoke.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from .cuda_lib import KernelLib, ptr, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
RESMLP = KernelLib("resmlp.cu", {"resmlp_launch": [
    _P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P]})

HIDDEN = 128
MAX_OUT = 8
# one ring entry of the kernel (csrc/chain.cuh STAGE_BYTES): a swizzled
# [128][128] bf16 layer, then its [128] f32 bias
LAYER_BYTES = HIDDEN * HIDDEN * 2
STAGE_BYTES = LAYER_BYTES + HIDDEN * 4


def _act(activation: str):
    if activation == "relu":
        return torch.relu
    if activation == "elu":
        return torch.nn.functional.elu
    raise ValueError(f"activation {activation} not supported")


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f32, or f64 for f64 weights (reference runs)."""
    return torch.promote_types(dtype, torch.float32)


def _mm(r, w, b, fast: bool):
    acc = _acc(w.dtype)
    out = r.to(w.dtype).to(acc) @ w.to(acc) + b.to(acc)
    return out.to(w.dtype) if fast else out


def resmlp_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 n_blocks: int, readout: bool = False,
                 activation: str = "relu", skip_input: bool = False,
                 fast: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the chain. x: [N, D_in] -> [N, H or out]."""
    act = _act(activation)
    if skip_input:
        h, idx = (x if fast else x.to(_acc(x.dtype))), 0
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


def swizzle_index(rows: int) -> torch.Tensor:
    """Element position of each (row, k) of a [rows][128] bf16 matrix in
    the canonical K-major 128-byte-swizzled wgmma layout: two 64-column
    halves of [rows][64] each, rows of 128 bytes, and 16-byte chunk c of
    row m stored at chunk c ^ (m % 8) (csrc/chain.cuh `sw128_offset`)."""
    m = torch.arange(rows)[:, None]
    k = torch.arange(HIDDEN)[None, :]
    return ((k // 64) * rows * 64 + m * 64 + (((k % 64) // 8) ^ (m % 8)) * 8
            + k % 8)


class ChainPack(NamedTuple):
    """A chain's weights as the kernels read them, built once."""
    ring: torch.Tensor           # [L, STAGE_BYTES] uint8, streamed in order
    wro: Optional[torch.Tensor]  # [out_dim, 128] bf16 readout ([out][in])
    bro: Optional[torch.Tensor]  # [out_dim] f32


def pack_ring(mats: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """[L, 128, 128] [out][in] layers and [L, 128] biases -> ring entries
    [L, STAGE_BYTES] uint8: each layer's bf16 weights in the swizzled order,
    then its f32 bias. One zero entry for L = 0, so that the kernel always
    gets a valid pointer."""
    if mats.shape[0] == 0:
        return torch.zeros((1, STAGE_BYTES), dtype=torch.uint8,
                           device=mats.device)
    idx = swizzle_index(HIDDEN).reshape(-1).to(mats.device)
    w = torch.empty((mats.shape[0], HIDDEN * HIDDEN), dtype=torch.bfloat16,
                    device=mats.device)
    w[:, idx] = mats.to(torch.bfloat16).reshape(mats.shape[0], -1)
    b = biases.float().contiguous()
    return torch.cat([w.view(torch.uint8), b.view(torch.uint8)], 1).contiguous()


def chain_layers(weights: Sequence[torch.Tensor], n_blocks: int,
                 skip_input: bool, device: torch.device):
    """Flat JAX-layout weights -> the ring's layers in order: the input
    Dense in 128-wide k-chunks of W0^T (zero past d_in; b0 with the last
    chunk), then each block's two layers. Returns ([L, 128, 128] [out][in],
    [L, 128] biases)."""
    mats, biases = [], []
    idx = 0
    if not skip_input:
        w0, b0 = weights[0], weights[1]
        d_in = w0.shape[0]
        w0t = torch.zeros((HIDDEN, -(-d_in // HIDDEN) * HIDDEN),
                          dtype=w0.dtype, device=w0.device)
        w0t[:, :d_in] = w0.t()
        chunks = list(w0t.split(HIDDEN, dim=1))
        mats += chunks
        biases += [torch.zeros_like(b0)] * (len(chunks) - 1) + [b0]
        idx = 2
    for i in range(n_blocks):
        wa, ba, wb, bb = weights[idx + 4 * i: idx + 4 * i + 4]
        mats += [wa.t(), wb.t()]
        biases += [ba, bb]
    if not mats:
        return (torch.zeros((0, HIDDEN, HIDDEN), device=device),
                torch.zeros((0, HIDDEN), device=device))
    return torch.stack(mats), torch.stack(biases)


def pack_chain(weights: Sequence[torch.Tensor], n_blocks: int,
               readout: bool = False, skip_input: bool = False,
               device: Optional[torch.device] = None) -> ChainPack:
    """The kernel's view of a chain's flat weights (see the module doc), on
    `device` (default: the weights')."""
    if device is None:
        device = weights[0].device if weights else torch.device("cpu")
    mats, biases = chain_layers(weights, n_blocks, skip_input, device)
    wro = bro = None
    if readout:
        wro = weights[-2].t().to(torch.bfloat16).contiguous()
        bro = weights[-1].float().contiguous()
    return ChainPack(pack_ring(mats, biases), wro, bro)


def _layout(x: torch.Tensor, weights: Sequence[torch.Tensor], n_blocks: int,
            readout: bool, skip_input: bool):
    """Checks x and the weights' count and shapes for a launch; returns
    (d_in, out_dim): 0 for skip_input / no readout."""
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.dim() == 2 and x.is_contiguous(), "x must be contiguous [N, D]")
    _check(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    _check(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype}")
    n_w = (0 if skip_input else 2) + 4 * n_blocks + (2 if readout else 0)
    _check(len(weights) == n_w, f"expected {n_w} weights, got {len(weights)}")
    _check(all(w.device == x.device for w in weights),
           "weights must be on x's device")
    idx = 0
    if skip_input:
        _check(x.shape[1] == HIDDEN, f"skip_input needs width {HIDDEN}")
        d_in = 0
    else:
        _check(tuple(weights[0].shape) == (x.shape[1], HIDDEN),
               "w0 must be [D_in, 128]")
        d_in, idx = x.shape[1], 2
    for i, w in enumerate(weights[idx:idx + 4 * n_blocks]):
        _check(tuple(w.shape) == ((HIDDEN, HIDDEN) if i % 2 == 0 else (HIDDEN,)),
               "block weights must be [128, 128] / [128]")
    out_dim = 0
    if readout:
        out_dim = weights[-2].shape[1]
        _check(weights[-2].shape[0] == HIDDEN and 0 < out_dim <= MAX_OUT,
               f"readout must be [128, <= {MAX_OUT}]")
    return d_in, out_dim


def _launch(x: torch.Tensor, pack: ChainPack, d_in: int, n_blocks: int,
            out_dim: int, activation: str, skip_input: bool,
            fast: bool) -> torch.Tensor:
    """Launches the kernel on checked inputs (`_layout`) and counts it."""
    _act(activation)
    n_layers = -(-d_in // HIDDEN) + 2 * n_blocks
    _check(pack.ring.device == x.device and pack.ring.is_contiguous()
           and pack.ring.shape == (max(n_layers, 1), STAGE_BYTES)
           and (pack.wro is None if out_dim == 0
                else pack.wro.shape == (out_dim, HIDDEN)),
           f"pack must hold [{max(n_layers, 1)}, {STAGE_BYTES}] ring entries "
           "and the readout on x's device")
    n = x.shape[0]
    out = torch.empty((n, out_dim or HIDDEN), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    round_stream = fast and (not skip_input or x.dtype == torch.bfloat16)
    RESMLP.call("resmlp_launch", ptr(x), ptr(out),
                int(x.dtype == torch.bfloat16), ptr(pack.ring), d_in,
                n_blocks, ptr(pack.wro), ptr(pack.bro), out_dim, n,
                int(fast), int(round_stream), int(activation == "elu"),
                stream_handle(x.device))
    RESMLP.counts["resmlp_rows"] += 1
    return out


def resmlp_rows(x: torch.Tensor, weights: Sequence[torch.Tensor],
                n_blocks: int, readout: bool = False,
                activation: str = "relu", skip_input: bool = False,
                fast: bool = False,
                pack: Optional[ChainPack] = None) -> torch.Tensor:
    """The fused chain over rows. A CPU tensor takes `resmlp_plain`; a CUDA
    tensor launches the kernel (bf16 weights, hidden 128, readout <= 8),
    from `pack` (`pack_chain` of the same weights) when given."""
    if x.device.type == "cpu":
        return resmlp_plain(x, weights, n_blocks, readout, activation,
                            skip_input, fast)
    d_in, out_dim = _layout(x, weights, n_blocks, readout, skip_input)
    _check(all(w.dtype == torch.bfloat16 for w in weights),
           "weights must be bf16")
    if pack is None:
        pack = pack_chain(weights, n_blocks, readout, skip_input, x.device)
    return _launch(x, pack, d_in, n_blocks, out_dim, activation, skip_input,
                   fast)


class _ResMLPDiff(torch.autograd.Function):
    """K1': kernel forward (f32 stream), plain recompute backward."""

    @staticmethod
    def forward(ctx, x, n_blocks, readout, activation, skip_input, pack,
                *weights):
        ctx.cfg = (n_blocks, readout, activation, skip_input)
        ctx.save_for_backward(x, *weights)
        if x.device.type == "cpu":
            return resmlp_plain(x, weights, n_blocks, readout, activation,
                                skip_input)
        d_in, out_dim = _layout(x, weights, n_blocks, readout, skip_input)
        if pack is None:                # the pack holds bf16 copies
            pack = pack_chain(weights, n_blocks, readout, skip_input,
                              x.device)
        out = _launch(x, pack, d_in, n_blocks, out_dim, activation,
                      skip_input, False)
        RESMLP.counts["resmlp_rows_diff"] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        """Differentiates the plain chain. Under `create_graph` (grad mode
        on here) the recompute runs on the saved tensors themselves, so the
        returned gradients carry the chain's second-order terms."""
        higher = torch.is_grad_enabled()
        need = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[6:])
        saved = ctx.saved_tensors
        inputs = (list(saved) if higher else
                  [t.detach().requires_grad_(n) for t, n in zip(saved, need)])
        wanted = [t for t, n in zip(inputs, need) if n]
        with torch.enable_grad():
            out = resmlp_plain(inputs[0], inputs[1:], *ctx.cfg)
            grads = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype),
                                             create_graph=higher))
        dx, *dw = [next(grads) if n else None for n in need]
        return (dx, None, None, None, None, None, *dw)


def resmlp_rows_diff(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     n_blocks: int, readout: bool = False,
                     activation: str = "relu", skip_input: bool = False,
                     pack: Optional[ChainPack] = None) -> torch.Tensor:
    """Differentiable `resmlp_rows` (f32 stream): forward through the kernel
    on a CUDA tensor (from `pack`, the weights' bf16 copies), through
    `resmlp_plain` on a CPU tensor; backward in both cases through
    `resmlp_plain` with the weights as given (f32 for an f32 model), as
    tcnerf/ops/pallas/resmlp.py `_resmlp_diff_bwd` does."""
    return _ResMLPDiff.apply(x, n_blocks, readout, activation, skip_input,
                             pack, *weights)
