"""Plain PyTorch layers of the reference, channels-last, float32.

The equations of the model as published in the thesis reference
(`TWeber132/thesis-clip-nerf`) and kept by the JAX package: flax layer
semantics (TF "SAME" padding), jax.image.resize's bilinear resampling
(antialiased when it shrinks), batch-statistics normalisation with eps
1e-3, tfa.interpolate_bilinear's clamped four-tap gather, and the Fourier
encoding ordered (channel, octave, [sin, cos]). Parameters are named as the
program names them, so one set of weights loads into both.

`LOWER` selects the control's arithmetic for the products of layers built
with `lower_ok=True`: None (float32), or "fp8" (both operands rounded to
float8 e4m3 with a per-tensor scale, the product accumulated in float32).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LOWER: dict = {"mode": None}
FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], lower_ok: bool = False):
    if lower_ok and LOWER["mode"] == "fp8":
        x, weight = fp8(x), fp8(weight)
    y = x @ weight.t()
    return y if bias is None else y + bias


class Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, use_bias: bool = True,
                 lower_ok: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out)) if use_bias else None
        self.lower_ok = lower_ok

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.lower_ok)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.scale + self.bias


class BatchStatNorm(nn.Module):
    """Normalised by the batch's own statistics over every axis but the
    channels (biased variance, eps 1e-3); no running state."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes, keepdim=True)
        var = ((x - mean) ** 2).mean(axes, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-3) * self.scale + self.bias


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """[B, H, W, C] convolution; weight OIHW; "SAME" pads TF-style (the odd
    pixel after), "VALID" not at all."""

    def __init__(self, n_in: int, n_out: int, k: int, stride: int = 1,
                 padding: str = "SAME", use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, k, k))
        self.bias = nn.Parameter(torch.zeros(n_out)) if use_bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            k = self.weight.shape[2]
            t, b = _same(x.shape[2], k, self.stride)
            l, r = _same(x.shape[3], k, self.stride)
            x = F.pad(x, (l, r, t, b))
        y = F.conv2d(x, self.weight, self.bias, stride=self.stride)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """Transposed convolution with kernel = stride (each input pixel
    writes its own k x k block); weight [in, out, k, k]."""

    def __init__(self, n_in: int, n_out: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, k, k))
        self.bias = nn.Parameter(torch.zeros(n_out))
        self.k = k

    def forward(self, x):
        b, h, w, _ = x.shape
        k = self.k
        # out[b, h*k + i, w*k + j, o] = sum_c x[b, h, w, c] W[c, o, i, j]
        y = torch.einsum("bhwc,coij->bhiwjo", x, self.weight)
        return y.reshape(b, h * k, w * k, -1) + self.bias


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of jax.image.resize "bilinear" on one axis:
    triangle kernel at half-pixel centres, widened by n_in / n_out when
    shrinking, renormalised over the samples that fall inside."""
    inv = 1.0 / torch.tensor(n_out / n_in, dtype=torch.float32)
    width = torch.clamp(inv, min=1.0)
    centre = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (centre[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
            ).abs() / width
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    b, h, w, c = x.shape
    if h != size[0]:
        x = torch.einsum("bhwc,ho->bowc", x,
                         _resize_weights(h, size[0], x.device))
    if w != size[1]:
        x = torch.einsum("bhwc,wp->bhpc", x,
                         _resize_weights(w, size[1], x.device))
    return x


def positional_encoding(x: torch.Tensor, n_freq: int = 10) -> torch.Tensor:
    """(..., D) -> (..., D * n_freq * 2): sin and cos of x * pi * 2^k."""
    freqs = math.pi * 2.0 ** torch.arange(n_freq, dtype=x.dtype,
                                          device=x.device)
    s = x[..., None] * freqs
    return torch.stack([torch.sin(s), torch.cos(s)], -1).reshape(
        x.shape[:-1] + (x.shape[-1] * n_freq * 2,))


def bilinear_gather(images: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C], xy [B, N, 2] as (column, row) -> [B, N, C]:
    the query clamped into the image, its cell's corner clamped to
    [0, size - 2], fractions from the clamped query."""
    b, h, w, c = images.shape
    x = xy[..., 0].clamp(0.0, w - 1.0)
    y = xy[..., 1].clamp(0.0, h - 1.0)
    x0 = torch.floor(x).clamp(0.0, w - 2.0)
    y0 = torch.floor(y).clamp(0.0, h - 2.0)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    flat = images.reshape(b, h * w, c)
    base = y0.long() * w + x0.long()

    def take(idx):
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))

    top = take(base) * (1 - fx) + take(base + 1) * fx
    bottom = take(base + w) * (1 - fx) + take(base + w + 1) * fx
    return top * (1 - fy) + bottom * fy
