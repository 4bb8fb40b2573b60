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
    """flax `nn.Dense`: weight in nn.Linear layout [out, in]. `kernel_init`
    names the flax initializer that `params.init_params` follows
    ("lecun_normal", flax's default, "glorot_uniform" or "he_normal")."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 kernel_init: str = "lecun_normal"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype
        self.kernel_init = kernel_init

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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, on |x|."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, far, near))


_KERNELS = {"bilinear": _triangle, "cubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, device=None,
                   method: str = "bilinear",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[in, out] weights of jax.image.resize(method=...) along one axis
    ("bilinear": triangle kernel, "cubic": Keys cubic, a = -0.5):
    half-pixel centres, the kernel widened by in/out when it shrinks
    (antialias), weights renormalised over in-range samples, all in
    `dtype` as jax/_src/image/scale.py compute_weight_mat computes them
    (jax's weak-typed scale: f32, f64 under jax_enable_x64)."""
    inv_scale = 1.0 / torch.tensor(out_size / in_size, dtype=dtype)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=dtype) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, dtype=dtype)[:, None]
            ).abs() / kernel_scale
    w = _KERNELS[method](dist)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device=device)


def resize(x: torch.Tensor, size: Tuple[int, int],
           method: str = "bilinear") -> torch.Tensor:
    """jax.image.resize(x, (B, *size, C), method) for [B, H, W, C], as
    separable weight-matrix products (fp32, core/prec.py); an axis whose
    size does not change is left as is, as jax.image.resize leaves it. The
    weights are f32, or f64 for f64 inputs (as JAX under x64 makes them)."""
    b, h, w, c = x.shape
    wdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    if h != size[0]:
        wh = resize_weights(h, size[0], x.device, method, wdt).to(x.dtype)
        x = torch.einsum("bhwc,ho->bowc", x, wh)
    if w != size[1]:
        ww = resize_weights(w, size[1], x.device, method, wdt).to(x.dtype)
        x = torch.einsum("bowc,wp->bopc", x, ww)
    return x


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, (B, *size, C), "bilinear") for [B, H, W, C]."""
    return resize(x, size, "bilinear")


def resize_cubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, (B, *size, C), "cubic") for [B, H, W, C]: Keys'
    kernel (a = -0.5), antialiased when shrinking and renormalised at the
    edges, which `F.interpolate(mode="bicubic")` (a = -0.75) is not."""
    return resize(x, size, "cubic")


def _pool(fn, x: torch.Tensor, window, strides) -> torch.Tensor:
    y = fn(x.permute(0, 3, 1, 2), _pair(window), _pair(strides))
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window, strides) -> torch.Tensor:
    """flax `nn.avg_pool` with VALID windows on [B, H, W, C]."""
    return _pool(F.avg_pool2d, x, window, strides)


def max_pool(x: torch.Tensor, window, strides) -> torch.Tensor:
    """flax `nn.max_pool` with VALID windows on [B, H, W, C]."""
    return _pool(F.max_pool2d, x, window, strides)
