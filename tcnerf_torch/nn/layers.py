"""Base layers with flax.linen semantics: parameter names (`kernel`-less:
torch layouts, see params.py), channels-last inputs and an optional compute
dtype.

`dtype=None` computes in the promotion of the input and parameter dtypes,
as flax's `promote_dtype` does; a dtype (e.g. `torch.bfloat16`) casts input
and parameters to it. Parameters themselves stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _compute_dtype(dtype, x: torch.Tensor, p: torch.Tensor) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, p.dtype)


class Dense(nn.Module):
    """flax `nn.Dense`: weight in nn.Linear layout [out, in]."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis (params `scale`, `bias`)."""

    def __init__(self, dim: int, epsilon: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.epsilon = epsilon
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.scale)
        return F.layer_norm(x.to(dt), x.shape[-1:], self.scale.to(dt),
                            self.bias.to(dt), self.epsilon)


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF/flax "SAME": out = ceil(size / s); the odd pixel pads after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """flax `nn.Conv` on [B, H, W, C]; weight OIHW. Padding "SAME" (TF
    style, explicit `F.pad`, so stride 2 pads bottom/right) or "VALID"."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides=1,
                 padding: str = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.strides = _pair(strides)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding} not supported")
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        xc = x.to(dt).permute(0, 3, 1, 2)          # NCHW view (channels-last)
        if self.padding == "SAME":
            kh, kw = self.weight.shape[2:]
            top, bottom = same_padding(xc.shape[2], kh, self.strides[0])
            left, right = same_padding(xc.shape[3], kw, self.strides[1])
            if top or bottom or left or right:
                xc = F.pad(xc, (left, right, top, bottom))
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(xc, self.weight.to(dt), b, stride=self.strides)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose` (transpose_kernel=False, padding "SAME") for
    kernel_size == strides, as the DPT decoder uses it. Weight in
    `conv_transpose2d` layout [in, out, kh, kw]; flax's HWIO kernel maps to
    it with a spatial flip (params.py)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        if (kh, kw) != _pair(strides):
            raise NotImplementedError("ConvTranspose: kernel_size != strides")
        self.weight = nn.Parameter(torch.empty(in_features, features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.strides = _pair(strides)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), b, stride=self.strides)
        return y.permute(0, 2, 3, 1)


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in, out] weights of jax.image.resize(method="bilinear") along one
    axis: half-pixel centres, triangle kernel widened by in/out when it
    shrinks (antialias), weights renormalised over in-range samples
    (jax/_src/image/scale.py compute_weight_mat)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float64) + 0.5) * inv_scale
              - 0.5)
    dist = (sample[None, :] - torch.arange(in_size, dtype=torch.float64)[:, None]
            ).abs() / kernel_scale
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device=device, dtype=torch.float32)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, (B, *size, C), "bilinear") for [B, H, W, C],
    as two separable weight-matrix products (fp32, core/prec.py)."""
    b, h, w, c = x.shape
    wh = resize_weights(h, size[0], x.device).to(x.dtype)
    ww = resize_weights(w, size[1], x.device).to(x.dtype)
    y = torch.einsum("bhwc,ho->bowc", x, wh)
    return torch.einsum("bowc,wp->bopc", y, ww)

