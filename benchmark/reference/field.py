"""The NeRF field of the reference: the pixel-conditioned MLP with mid-network
mean view fusion, its readouts, and the camera geometry that feeds it.

Geometry keeps the published quirks: directions are taken into a camera's
frame with w = 1 (so the camera's translation leaks into them), pixel
coordinates are the projection over max(z, 1e-8), clipped to +-1e6.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, positional_encoding


def act(name: str):
    return {"relu": torch.relu, "elu": F.elu}[name]


class ResBlock(nn.Module):
    """shortcut(x) + layer_1(act(layer_0(act(x))))."""

    def __init__(self, n_in: int, hidden: int, n_out: int,
                 shortcut: bool = False, activation: str = "relu",
                 lower_ok: bool = False):
        super().__init__()
        self.activation = activation
        self.layer_0 = Dense(n_in, hidden, lower_ok=lower_ok)
        self.layer_1 = Dense(hidden, n_out, lower_ok=lower_ok)
        self.shortcut = (Dense(n_in, n_out, use_bias=False) if shortcut
                         else None)

    def forward(self, x):
        a = act(self.activation)
        y = self.layer_1(a(self.layer_0(a(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + y


class Embedding(nn.Module):
    """Fourier encodings of the camera-frame position and direction beside
    the gathered features, `layer_0`, n_blocks // 2 feature blocks, the mean
    over views, the fusion blocks. `forward` returns every activation:
    [layer_0, feature blocks..., mean, fusion blocks...]."""

    def __init__(self, n_features_in: int, n_blocks: int, hidden: int,
                 n_views: int, n_freq: int = 10):
        super().__init__()
        self.n_views, self.n_freq = n_views, n_freq
        pd = 12 * n_freq
        self.layer_0 = Dense(pd + n_features_in, hidden, lower_ok=True)
        half = n_blocks // 2
        for i in range(n_blocks):
            name = (f"feature_block_{i}" if i < half
                    else f"fusion_block_{i - half}")
            self.add_module(name, ResBlock(hidden, hidden, hidden,
                                           lower_ok=True))
        self.n_feature, self.n_fusion = half, n_blocks - half

    def forward(self, positions, directions, features) -> List[torch.Tensor]:
        enc = torch.cat([positional_encoding(positions, self.n_freq),
                         positional_encoding(directions, self.n_freq)], -1)
        out = [self.layer_0(torch.cat([enc, features], -1))]
        for i in range(self.n_feature):
            out.append(getattr(self, f"feature_block_{i}")(out[-1]))
        x = out[-1]
        out.append(x.reshape((-1, self.n_views) + x.shape[1:]).mean(1))
        for i in range(self.n_fusion):
            out.append(getattr(self, f"fusion_block_{i}")(out[-1]))
        return out


class RenderReadout(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.output_layer = Dense(hidden, 4, lower_ok=True)

    def forward(self, x):
        out = self.output_layer(torch.relu(x))
        return torch.sigmoid(out[..., :3]), F.softplus(out[..., 3])


def homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def project(points: torch.Tensor, intrinsics: torch.Tensor,
            extrinsics_inv: torch.Tensor):
    """World points [B, ..., 3] (one leading batch axis), cameras
    [B, V, 4, 4] -> (pixel xy [B, V, ..., 2], camera points
    [B, V, ..., 3])."""
    lead = points.shape[1:-1]
    p = homogeneous(points).reshape(points.shape[0], 1, -1, 4)
    cam = p @ extrinsics_inv.transpose(-1, -2)          # [B, V, M, 4]
    proj = cam @ intrinsics.transpose(-1, -2)
    xy = proj[..., :2] / proj[..., 2:3].clamp(min=1e-8)
    xy = xy.clamp(-1e6, 1e6)
    b, v = cam.shape[:2]
    return (xy.reshape((b, v) + lead + (2,)),
            cam[..., :3].reshape((b, v) + lead + (3,)))


def directions_to_cameras(directions: torch.Tensor,
                          extrinsics_inv: torch.Tensor) -> torch.Tensor:
    """World directions [B, ..., 3] -> [B, V, ..., 3], homogenised with
    w = 1 (the published quirk)."""
    lead = directions.shape[1:-1]
    d = homogeneous(directions).reshape(directions.shape[0], 1, -1, 4)
    cam = d @ extrinsics_inv.transpose(-1, -2)
    b, v = cam.shape[:2]
    return cam[..., :3].reshape((b, v) + lead + (3,))
