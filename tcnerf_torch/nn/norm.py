"""Batch-statistics normalisation (tcnerf/nn/norm.py).

Written out rather than `nn.BatchNorm2d`: it always normalises with the
current batch's statistics, uses the biased variance, eps=1e-3 (the keras
default) and keeps no running state — what the reference network saw in
training (its conv-path BatchNorm is called with training=True always).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class BatchStatNorm(nn.Module):
    """Channels-last: statistics over every axis but the last."""

    def __init__(self, num_features: int, epsilon: float = 1e-3,
                 dtype: Optional[torch.dtype] = None,
                 reduction_axes: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.epsilon = epsilon
        self.dtype = dtype
        self.reduction_axes = reduction_axes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = self.reduction_axes or tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias
