"""Dense residual blocks and readout heads (tcnerf/nn/blocks.py)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense


def activation_fn(name: str):
    if name == "relu":
        return torch.relu
    if name == "elu":
        return F.elu
    raise ValueError(f"activation {name} not supported")


class ResNetMLPBlock(nn.Module):
    """Pre-activation dense residual block:
    shortcut(x) + layer_1(act(layer_0(act(x))))."""

    def __init__(self, in_features: int, hidden_size: int, output_size: int,
                 transform_shortcut: bool = False, activation: str = "relu",
                 kernel_initializer: str = "lecun_normal",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation
        kw = dict(dtype=dtype, kernel_init=kernel_initializer)
        self.layer_0 = Dense(in_features, hidden_size, **kw)
        self.layer_1 = Dense(hidden_size, output_size, **kw)
        self.shortcut = (Dense(in_features, output_size, use_bias=False, **kw)
                         if transform_shortcut else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = activation_fn(self.activation)
        residual = self.layer_1(act(self.layer_0(act(x))))
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return shortcut + residual


class RenderReadout(nn.Module):
    """relu -> Dense(4) -> (sigmoid RGB, softplus density)."""

    def __init__(self, in_features: int, output_size: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.output_layer = Dense(in_features, output_size, dtype=dtype)

    def forward(self, x: torch.Tensor):
        out = self.output_layer(torch.relu(x))
        return torch.sigmoid(out[..., :3]), F.softplus(out[..., 3])


class Readout(nn.Module):
    """relu -> Dense(out)."""

    def __init__(self, in_features: int, output_size: int,
                 use_bias: bool = True,
                 kernel_initializer: str = "lecun_normal",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.output_layer = Dense(in_features, output_size, use_bias=use_bias,
                                  dtype=dtype, kernel_init=kernel_initializer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_layer(torch.relu(x))
