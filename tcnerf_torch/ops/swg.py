"""Fused field stage of the serving path: wrapper of the CUDA kernel
`csrc/swg.cu` and its plain PyTorch version.

Per query: bilinear gather of the pre-projected `[H, W, 128]` image at
(x, y), plus the geometry head (Fourier octaves of the camera-frame
position and direction through rows [:pd] of layer_0, plus its bias), then
the residual chain and relu -> readout, giving raw logits `[N, out]` in
query order. Two modes:

  * head inside (`h0_geo=None`): the port of tcnerf/ops/pallas/swg.py:246
    `swg_gather_mlp_t` (K2) — octaves by the double-angle recurrence, head
    product in bf16 with f32 accumulation, always the bf16 (`fast`) stream;
  * head given (`h0_geo` passed): the port of swg.py:362 `swg_gather_mlp`
    (K3) — the head output comes from `encode_head`; `fast` or f32 stream.

The TPU kernels' sorted windows, scalar-prefetched window bases, packed
keys and fractions, overflow patch/fallback and unsort are TPU layout
devices: the CUDA kernel gathers directly and cannot overflow.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.encoding import positional_encoding_fast
from .cuda_lib import KernelLib, ptr, stream_handle
from .interpolate import bilinear_gather
from .resmlp import (HIDDEN, MAX_OUT, STAGE_BYTES, ChainPack, chain_layers,
                     pack_ring, resmlp_plain)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SWG = KernelLib("swg.cu", {"swg_launch": [
    _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _I, _P, _P, _I, _I, _I, _I,
    _P, _P]})


def encode_head(pos: torch.Tensor, dirs: torch.Tensor, head_k: torch.Tensor,
                head_b: torch.Tensor, dtype: torch.dtype, n_freq: int = 10,
                base_freq: float = math.pi) -> torch.Tensor:
    """Geometry-head output [N, hidden] in `dtype` (bias included):
    double-angle octaves of pos and dirs in the reference (d, n, [sin, cos])
    order, cast to `dtype`, times head_k [pd, hidden] with f32 accumulation."""
    enc = torch.cat([positional_encoding_fast(pos, n_freq, base_freq),
                     positional_encoding_fast(dirs, n_freq, base_freq)], -1)
    out = enc.to(dtype).float() @ head_k.to(dtype).float() \
        + head_b.to(dtype).float()
    return out.to(dtype)


def swg_field_plain(img: torch.Tensor, coords: torch.Tensor,
                    pos: Optional[torch.Tensor], dirs: Optional[torch.Tensor],
                    weights: Sequence[torch.Tensor], n_blocks: int,
                    head_k: Optional[torch.Tensor] = None,
                    head_b: Optional[torch.Tensor] = None,
                    h0_geo: Optional[torch.Tensor] = None, fast: bool = True,
                    n_freq: int = 10, base_freq: float = math.pi,
                    activation: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of the field stage. Returns f32 [N, out]."""
    dt = weights[0].dtype
    feats = bilinear_gather(img[None], coords[None])[0].float()  # f32 lerp
    if h0_geo is None:
        enc = torch.cat([positional_encoding_fast(pos, n_freq, base_freq),
                         positional_encoding_fast(dirs, n_freq, base_freq)], -1)
        head = enc.to(dt).float() @ head_k.to(dt).float()
        h0 = feats + head + head_b.float()
    else:
        h0 = feats + h0_geo.float()
    h = h0.to(dt) if fast else h0
    return resmlp_plain(h, weights, n_blocks, readout=True,
                        activation=activation, skip_input=True,
                        fast=fast).float()


def head_permutation(n_freq: int) -> np.ndarray:
    """Kernel encoding column j -> reference head row. Kernel columns run
    f (sin, cos), octave, channel (pos xyz, dir xyz); reference rows run
    (input, channel, octave, f)."""
    cols = []
    for f in range(2):
        for k in range(n_freq):
            for ch in range(6):
                blk, dd = divmod(ch, 3)
                cols.append(blk * 6 * n_freq + dd * 2 * n_freq + k * 2 + f)
    return np.asarray(cols)


@functools.lru_cache(maxsize=None)
def _head_permutation_on(n_freq: int, device: torch.device) -> torch.Tensor:
    # cached: a host-to-device copy at every launch would synchronise the
    # stream and keep the host from running ahead of the card
    return torch.as_tensor(head_permutation(n_freq), device=device)


def pack_swg(weights: Sequence[torch.Tensor], n_blocks: int,
             head_k: Optional[torch.Tensor] = None,
             head_b: Optional[torch.Tensor] = None,
             n_freq: int = 10) -> ChainPack:
    """The kernel's view of a field stage, built once per stage: ring entry
    0 is the head (head_k's rows in the kernel's encoding-column order,
    zero past 12 * n_freq, and head_b; zero without a head), then the
    2 * n_blocks chain layers; the head-given mode streams `ring[1:]`."""
    dev = weights[-1].device
    head_t = torch.zeros((HIDDEN, HIDDEN), dtype=torch.bfloat16, device=dev)
    hb = torch.zeros((1, HIDDEN), device=dev)
    if head_k is not None:
        head_t[:, :12 * n_freq] = \
            head_k[_head_permutation_on(n_freq, dev)].t().to(torch.bfloat16)
        hb = head_b.float()[None]
    mats, biases = chain_layers(weights[:-2], n_blocks, True, dev)
    mats = torch.cat([head_t[None], mats.to(torch.bfloat16)])
    biases = torch.cat([hb, biases.float()])
    return ChainPack(pack_ring(mats, biases),
                     weights[-2].t().to(torch.bfloat16).contiguous(),
                     weights[-1].float().contiguous())


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"swg_field_rows: {msg}")


def swg_field_rows(img: torch.Tensor, coords: torch.Tensor,
                   pos: Optional[torch.Tensor], dirs: Optional[torch.Tensor],
                   weights: Sequence[torch.Tensor], n_blocks: int,
                   head_k: Optional[torch.Tensor] = None,
                   head_b: Optional[torch.Tensor] = None,
                   h0_geo: Optional[torch.Tensor] = None, fast: bool = True,
                   n_freq: int = 10, base_freq: float = math.pi,
                   activation: str = "relu",
                   pack: Optional[ChainPack] = None) -> torch.Tensor:
    """The fused field stage. A CPU image takes `swg_field_plain`; a CUDA
    image launches the kernel (bf16 image and weights, hidden 128), from
    `pack` (`pack_swg` of the same weights and head) when given."""
    if img.device.type == "cpu":
        return swg_field_plain(img, coords, pos, dirs, weights, n_blocks,
                               head_k, head_b, h0_geo, fast, n_freq,
                               base_freq, activation)
    dev = img.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(img.dim() == 3 and img.shape[2] == HIDDEN and img.is_contiguous()
           and img.dtype == torch.bfloat16,
           "img must be contiguous bf16 [H, W, 128]")
    h, w = img.shape[:2]
    _check(h >= 2 and w >= 2, "img must be at least 2x2")
    n = coords.shape[0]
    _check(coords.shape == (n, 2) and coords.dtype == torch.float32
           and coords.is_contiguous() and coords.device == dev,
           "coords must be contiguous f32 [N, 2] on img's device")
    _check(len(weights) == 4 * n_blocks + 2, "weights: blocks + readout")
    for wt in weights:
        _check(wt.device == dev and wt.dtype == torch.bfloat16,
               "weights must be bf16 on img's device")
    _check(activation in ("relu", "elu"), f"activation {activation}")
    out_dim = weights[-2].shape[1]
    _check(weights[-2].shape[0] == HIDDEN and 0 < out_dim <= MAX_OUT,
           f"readout must be [128, <= {MAX_OUT}]")
    _check(1 <= n_freq and 12 * n_freq <= HIDDEN, f"n_freq {n_freq}")
    if h0_geo is None:
        _check(fast, "head-inside mode runs the bf16 stream only (fast=True)")
        for name, t in (("pos", pos), ("dirs", dirs)):
            _check(t is not None and t.shape == (n, 3)
                   and t.dtype == torch.float32 and t.is_contiguous()
                   and t.device == dev, f"{name} must be contiguous f32 [N, 3]")
        if pack is None:
            _check(head_k is not None and head_b is not None
                   and head_k.shape == (12 * n_freq, HIDDEN)
                   and head_b.shape == (HIDDEN,),
                   "head_k must be [12 * n_freq, 128], head_b [128]")
        mode = "swg_head_inside"
    else:
        _check(h0_geo.shape == (n, HIDDEN) and h0_geo.dtype == torch.bfloat16
               and h0_geo.is_contiguous() and h0_geo.device == dev,
               "h0_geo must be contiguous bf16 [N, 128]")
        pos = dirs = None
        mode = "swg_head_given"
    if pack is None:
        pack = pack_swg(weights, n_blocks, head_k, head_b, n_freq)
    _check(pack.ring.device == dev and pack.ring.is_contiguous()
           and pack.ring.shape == (1 + 2 * n_blocks, STAGE_BYTES)
           and pack.wro.shape == (out_dim, HIDDEN),
           f"pack must hold [{1 + 2 * n_blocks}, {STAGE_BYTES}] ring entries "
           f"and a [{out_dim}, 128] readout on img's device")
    ring = pack.ring if h0_geo is None else pack.ring[1:]
    out = torch.empty((n, out_dim), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    SWG.call("swg_launch", int(h0_geo is None), ptr(coords), ptr(pos),
             ptr(dirs), ptr(h0_geo), ptr(img), h, w, ptr(ring), n_freq,
             float(base_freq), n_blocks, ptr(pack.wro), ptr(pack.bro),
             out_dim, n, int(fast), int(activation == "elu"), ptr(out),
             stream_handle(dev))
    SWG.counts[mode] += 1
    return out
