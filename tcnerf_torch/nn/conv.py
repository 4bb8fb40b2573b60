"""Convolutional half-resolution image encoder (tcnerf/nn/conv.py).

Reference quirks kept: each residual block uses ONE shared batch-stat norm
after both convs, and norms always use batch statistics. Inputs and outputs
are channels-last [B, H, W, C], as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Conv
from .norm import BatchStatNorm


class ConvResBlock(nn.Module):
    """2x conv3x3 residual block with one shared batch-stat norm."""

    def __init__(self, in_features: int, n_features: int,
                 downsample: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_1 = BatchStatNorm(n_features, dtype=dtype)
        self.conv_1 = Conv(in_features, n_features, 3, dtype=dtype)
        self.conv_2 = Conv(n_features, n_features, 3, dtype=dtype)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(in_features, n_features, 1,
                                        use_bias=False, dtype=dtype)
            self.downsample_norm = BatchStatNorm(n_features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.norm_1(self.conv_1(x)))
        out = self.norm_1(self.conv_2(out))
        skip = (self.downsample_norm(self.downsample_conv(x))
                if self.downsample else x)
        return torch.relu(out + skip)


class ConvolutionalEncoder(nn.Module):
    """conv7x7/2 stem + 3 residual blocks -> half-res, n_features//2 channels."""

    def __init__(self, n_features: int = 256, in_features: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        half = n_features // 2
        self.stem_conv = Conv(in_features, 64, 7, strides=2, use_bias=False,
                              dtype=dtype)
        self.stem_norm = BatchStatNorm(64, dtype=dtype)
        self.block_0 = ConvResBlock(64, half, downsample=True, dtype=dtype)
        self.block_1 = ConvResBlock(half, half, dtype=dtype)
        self.block_2 = ConvResBlock(half, half, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem_norm(self.stem_conv(x)))
        return self.block_2(self.block_1(self.block_0(x)))
