"""CLIP-pyramid x visual-feature fusion decoders V0..V4 (tcnerf/nn/fusion.py).

Every variant takes
  clip_outputs = (embedding [N, E], l1 [N, h1, w1, c1], .., l4 [N, h4, w4, c4])
  visual_features [N, H/2, W/2, C]
  clip_textuals [N, T] (the V3/V4 gates; a ones placeholder in the NeRF
  models)
and returns (fused feature image [N, H, W, 256], aux loss). Only V2 has an
aux loss (a CLIP self-reconstruction cross-entropy); the others return 0.
Sizes follow the visual-feature map, so shrunken test configs work as is.
The port's modules are sized at construction: `clip_channels` (c1..c4,
RN50: 256, 512, 1024, 2048), `vis_features` (C) and `text_features` (T).
Every resize is jax.image.resize's bilinear, antialiased when it shrinks
(nn/layers.py `resize_bilinear`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.bounds import clip
from .layers import Conv, Dense, max_pool, resize_bilinear



def _activation(name: str):
    return torch.relu if name == "relu" else F.elu


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


class DoubleConv(nn.Module):
    def __init__(self, in_features: int, filters: int,
                 activation: str = "relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.act = _activation(activation)
        self.conv_1 = Conv(in_features, filters, 3, use_bias=False,
                           dtype=dtype)
        self.conv_2 = Conv(filters, filters, 3, use_bias=False, dtype=dtype)

    def forward(self, x):
        return self.act(self.conv_2(self.act(self.conv_1(x))))


class Up(nn.Module):
    """Upsample 2x, concat a CLIP level resized to `shape`, double conv.
    (flax's `Up` holds `shape` as an attribute; here it is an argument.)"""

    def __init__(self, in_features: int, clip_features: int, filters: int,
                 activation: str = "relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.double_conv = DoubleConv(in_features + clip_features, filters,
                                      activation, dtype=dtype)

    def forward(self, x, clip_x, shape: Tuple[int, int]):
        x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2))
        x = torch.cat([x, resize_bilinear(clip_x, shape)], dim=-1)
        return self.double_conv(x)


class ConvFusion(nn.Module):
    """concat -> activation -> 1x1 conv."""

    def __init__(self, in_features: int, filters: int,
                 activation: str = "relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.act = _activation(activation)
        self.conv = Conv(in_features, filters, 1, use_bias=False, dtype=dtype)

    def forward(self, x1, x2):
        return self.conv(self.act(torch.cat([x1, x2], dim=-1)))


class MultiplyFusion(nn.Module):
    """Channel-wise gate by the text embedding: projected by a bias-free
    Dense (`use_dense`) or its first `filters` entries."""

    def __init__(self, text_features: int, filters: int,
                 use_dense: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.filters = filters
        self.use_dense = use_dense
        if use_dense:
            self.tile_dense = Dense(text_features, filters, use_bias=False,
                                    dtype=dtype)

    def forward(self, x, clip_textuals):
        t = (self.tile_dense(clip_textuals) if self.use_dense
             else clip_textuals[:, :self.filters])
        return x * t[:, None, None, :]


class _UNetFusion(nn.Module):
    """Shared body of V3/V4 (V4 narrows up_3 to 128 channels)."""

    up3_filters = 256

    def __init__(self, clip_channels: Sequence[int], vis_features: int,
                 text_features: int, use_dense: bool = False,
                 activation: str = "relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c1, c2, c3, c4 = clip_channels
        kw = dict(dtype=dtype)
        self.act = _activation(activation)
        self.conv = Conv(c4, 1024, 3, use_bias=False, **kw)
        self.multiply_fusion_1 = MultiplyFusion(text_features, 1024,
                                                use_dense, **kw)
        self.up_1 = Up(1024, c3, 512, activation, **kw)
        self.multiply_fusion_2 = MultiplyFusion(text_features, 512,
                                                use_dense, **kw)
        self.conv_fusion_1 = ConvFusion(512 + vis_features, 512, activation,
                                        **kw)
        self.up_2 = Up(512, c2, 256, activation, **kw)
        self.multiply_fusion_3 = MultiplyFusion(text_features, 256,
                                                use_dense, **kw)
        self.conv_fusion_2 = ConvFusion(256 + vis_features, 256, activation,
                                        **kw)
        self.up_3 = Up(256, c1, self.up3_filters, activation, **kw)
        self.conv_fusion_3 = ConvFusion(self.up3_filters + vis_features, 256,
                                        activation, **kw)

    def forward(self, clip_outputs, visual_features, clip_textuals):
        _, clip_l1, clip_l2, clip_l3, clip_l4 = clip_outputs
        vh, vw = visual_features.shape[1:3]
        vis_1 = resize_bilinear(visual_features, (vh // 2, vw // 2))
        vis_2 = resize_bilinear(visual_features, (vh // 4, vw // 4))
        x = self.act(self.conv(resize_bilinear(clip_l4, (vh // 8, vw // 8))))
        x = self.multiply_fusion_1(x, clip_textuals)
        x = self.up_1(x, clip_l3, (vh // 4, vw // 4))
        x = self.multiply_fusion_2(x, clip_textuals)
        x = self.conv_fusion_1(x, vis_2)
        x = self.up_2(x, clip_l2, (vh // 2, vw // 2))
        x = self.multiply_fusion_3(x, clip_textuals)
        x = self.conv_fusion_2(x, vis_1)
        x = self.conv_fusion_3(self.up_3(x, clip_l1, (vh, vw)),
                               visual_features)
        x = resize_bilinear(x, (vh * 2, vw * 2))
        return x, _zero(x)


class CombineCLIPVisualV3(_UNetFusion):
    up3_filters = 256


class CombineCLIPVisualV4(_UNetFusion):
    up3_filters = 128


class Level(nn.Module):
    """Per-scale fusion: a 1x1-projected CLIP level and the visual features,
    both at 1/downscale of the visual size, concatenated, 1x1 conv, resized
    back."""

    def __init__(self, downscale: int, clip_features: int, vis_features: int,
                 filters: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.downscale = downscale
        self.pre_conv = Conv(clip_features, filters, 1, use_bias=False,
                             dtype=dtype)
        self.post_conv = Conv(filters + vis_features, filters, 1,
                              use_bias=False, dtype=dtype)

    def forward(self, clip_x, vis):
        vh, vw = vis.shape[1:3]
        d = (vh // self.downscale, vw // self.downscale)
        x = torch.cat([resize_bilinear(self.pre_conv(clip_x), d), resize_bilinear(vis, d)],
                      dim=-1)
        return resize_bilinear(self.post_conv(x), (vh, vw))


class CombineCLIPVisualV0(nn.Module):
    """CLIP layer1 resized to the visual size, concat, 1x1 conv, 2x up."""

    def __init__(self, clip_channels: Sequence[int], vis_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(clip_channels[0] + vis_features, 256, 1,
                         use_bias=False, dtype=dtype)

    def forward(self, clip_outputs, visual_features, clip_textuals=None):
        vh, vw = visual_features.shape[1:3]
        clip_l1 = resize_bilinear(clip_outputs[1], (vh, vw))
        x = self.conv(torch.cat([clip_l1, visual_features], dim=-1))
        return resize_bilinear(x, (vh * 2, vw * 2)), _zero(x)


class CombineCLIPVisualV1(nn.Module):
    """Four `Level`s (downscale 1, 2, 4, 8), concat, 1x1 conv, 2x up."""

    def __init__(self, clip_channels: Sequence[int], vis_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for i, c in enumerate(clip_channels):
            self.add_module(f"level_{i + 1}",
                            Level(2 ** i, c, vis_features, dtype=dtype))
        self.conv = Conv(4 * 256, 256, 1, use_bias=False, dtype=dtype)

    def fuse(self, clip_outputs, visual_features):
        levels = [getattr(self, f"level_{i + 1}")(clip_outputs[i + 1],
                                                  visual_features)
                  for i in range(4)]
        return self.conv(torch.cat(levels, dim=-1))

    def forward(self, clip_outputs, visual_features, clip_textuals=None):
        vh, vw = visual_features.shape[1:3]
        x = self.fuse(clip_outputs, visual_features)
        return resize_bilinear(x, (vh * 2, vw * 2)), _zero(x)


class CombineCLIPVisualV2(CombineCLIPVisualV1):
    """V1, plus the aux loss: a 2x2 max-pool grid of the fused map,
    flattened, against the CLIP embedding by categorical cross-entropy."""

    def forward(self, clip_outputs, visual_features, clip_textuals=None):
        vh, vw = visual_features.shape[1:3]
        x = self.fuse(clip_outputs, visual_features)
        window = (vh // 2, vw // 2)
        pred = max_pool(x, window, window).reshape(x.shape[0], -1)
        aux = _categorical_crossentropy(clip_outputs[0], pred)
        return resize_bilinear(x, (vh * 2, vw * 2)), aux


def _categorical_crossentropy(y_true, y_pred, eps: float = 1e-7):
    """keras CategoricalCrossentropy(from_logits=False): normalise the
    prediction, clip it to [eps, 1 - eps]."""
    p = y_pred / clip(y_pred.sum(dim=-1, keepdim=True), eps)
    p = clip(p, eps, 1.0 - eps)
    return -(y_true * torch.log(p)).sum(dim=-1).mean()


FUSIONS = {
    "v0": CombineCLIPVisualV0,
    "v1": CombineCLIPVisualV1,
    "v2": CombineCLIPVisualV2,
    "v3": CombineCLIPVisualV3,
    "v4": CombineCLIPVisualV4,
}
