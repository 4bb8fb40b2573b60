"""The visual encoder of the reference: ViT-B/16 with four hooked blocks,
the DPT-style decoder over them, and the convolutional half-resolution
path beside it (`VisualFeatures`: [B, H, W, 3] -> [B, H/2, W/2, C]).

Quirks of the published model kept: LayerNorm eps 1e-5, exact GELU, the
second residual of a transformer block adds the block's input, and the
convolutional path's residual block uses one shared batch-statistics norm
after both of its convolutions.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BatchStatNorm, Conv, ConvTranspose, Dense, LayerNorm,
                     resize)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm_1 = LayerNorm(dim, 1e-5)
        self.q = Dense(dim, dim)
        self.k = Dense(dim, dim)
        self.v = Dense(dim, dim)
        self.attn_out = Dense(dim, dim)
        self.norm_2 = LayerNorm(dim, 1e-5)
        self.mlp_0 = Dense(dim, 4 * dim)
        self.mlp_1 = Dense(4 * dim, dim)

    def forward(self, inputs):
        x = self.norm_1(inputs)
        b, t, d = x.shape

        def split(y):
            return y.reshape(b, t, self.heads, d // self.heads).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // self.heads),
                          dim=-1) @ v
        x = inputs + self.attn_out(a.transpose(1, 2).reshape(b, t, d))
        y = self.mlp_1(F.gelu(self.mlp_0(self.norm_2(x))))
        return inputs + y


class ViT(nn.Module):
    def __init__(self, size: Tuple[int, int], patch: int, dim: int,
                 heads: int, hooks: Sequence[int]):
        super().__init__()
        self.dim, self.hooks = dim, tuple(hooks)
        self.grid = (size[0] // patch, size[1] // patch)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(3, dim, patch, stride=patch,
                                     padding="VALID")
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1] + 1, dim))
        for i in range(self.hooks[-1]):
            self.add_module(f"block_{i}", Block(dim, heads))

    def forward(self, images):
        x = self.patch_embed.proj(images)
        b = x.shape[0]
        x = x.reshape(b, -1, self.dim)
        x = torch.cat([self.cls_token.expand(b, 1, self.dim), x], 1)
        x = x + self.pos_embedding
        hooked, i = [], 0
        for hook in self.hooks:
            while i < hook:
                x = getattr(self, f"block_{i}")(x)
                i += 1
            hooked.append(x)
        return hooked


class DPT(nn.Module):
    def __init__(self, size, patch, dim, heads, hooks, n_features,
                 widths=(48, 96, 192, 384)):
        super().__init__()
        f = widths
        self.vit = ViT(size, patch, dim, heads, hooks)
        self.pp1_conv = Conv(dim, f[0], 1)
        self.pp1_deconv = ConvTranspose(f[0], f[0], 4)
        self.pp2_conv = Conv(dim, f[1], 1)
        self.pp2_deconv = ConvTranspose(f[1], f[1], 2)
        self.pp3_conv = Conv(dim, f[2], 1)
        self.pp4_conv = Conv(dim, f[3], 1)
        self.pp4_down = Conv(f[3], f[3], 3, stride=2)
        for i, c in enumerate(f):
            self.add_module(f"decode_{i + 1}", Conv(c, n_features, 3,
                                                    use_bias=False))
        self.out_conv_1 = Conv(4 * n_features, n_features, 3)
        self.out_conv_2 = Conv(n_features, n_features // 2, 3)

    def forward(self, images):
        gh, gw = self.vit.grid
        maps = [t[:, 1:].reshape(t.shape[0], gh, gw, t.shape[-1])
                for t in self.vit(images)]
        parts = [self.pp1_deconv(self.pp1_conv(maps[0])),
                 self.pp2_deconv(self.pp2_conv(maps[1])),
                 self.pp3_conv(maps[2]),
                 self.pp4_down(self.pp4_conv(maps[3]))]
        ups = []
        for i, (x, scale) in enumerate(zip(parts, (2, 4, 8, 16))):
            x = getattr(self, f"decode_{i + 1}")(x)
            ups.append(resize(x, (x.shape[1] * scale, x.shape[2] * scale)))
        x = torch.relu(self.out_conv_1(torch.relu(torch.cat(ups, -1))))
        return self.out_conv_2(x)


class ResBlock(nn.Module):
    def __init__(self, n_in: int, n: int, downsample: bool):
        super().__init__()
        self.norm_1 = BatchStatNorm(n)
        self.conv_1 = Conv(n_in, n, 3)
        self.conv_2 = Conv(n, n, 3)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(n_in, n, 1, use_bias=False)
            self.downsample_norm = BatchStatNorm(n)

    def forward(self, x):
        out = torch.relu(self.norm_1(self.conv_1(x)))
        out = self.norm_1(self.conv_2(out))
        skip = (self.downsample_norm(self.downsample_conv(x))
                if self.downsample else x)
        return torch.relu(out + skip)


class ConvPath(nn.Module):
    def __init__(self, n_features: int):
        super().__init__()
        half = n_features // 2
        self.stem_conv = Conv(3, 64, 7, stride=2, use_bias=False)
        self.stem_norm = BatchStatNorm(64)
        self.block_0 = ResBlock(64, half, True)
        self.block_1 = ResBlock(half, half, False)
        self.block_2 = ResBlock(half, half, False)

    def forward(self, x):
        x = torch.relu(self.stem_norm(self.stem_conv(x)))
        return self.block_2(self.block_1(self.block_0(x)))


class VisualFeatures(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.image_size = tuple(c["image_size"])
        self.vit_size = tuple(c["vit_size"])
        self.vision_transformer = DPT(self.vit_size, c["vit_patch"],
                                      c["vit_dim"], c["vit_heads"],
                                      c["vit_hooks"], c["n_features"])
        self.conv_features = ConvPath(c["n_features"])

    def forward(self, images):
        latents = self.vision_transformer(resize(images, self.vit_size))
        latents = resize(latents, (self.image_size[0] // 2,
                                   self.image_size[1] // 2))
        return torch.cat([latents, self.conv_features(images)], -1)


def full_resolution(features: torch.Tensor) -> torch.Tensor:
    """[N, h, w, C] -> [N, 2h, 2w, C], bilinear."""
    return resize(features, (features.shape[1] * 2, features.shape[2] * 2))
