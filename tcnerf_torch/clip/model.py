"""CLIP RN50 image tower and text transformer (tcnerf/clip/model.py).

Frozen feature extractors: every BatchNorm keeps its running statistics as
plain parameters (`FrozenBatchNorm`), as inference-mode CLIP does; the
trainer's 'frozen' group never updates them. `ModifiedResNet` returns the
5-tuple (global embedding [N, output_dim], then the four residual stages
[N, h, w, 4*width .. 32*width]); the text tower returns [N, output_dim].

Kept from the JAX package (not OpenAI's layout): TF "SAME" convolutions,
which at stride 2 pad bottom/right where OpenAI pads both sides by one;
flax's LayerNorm epsilon 1e-6 (OpenAI: 1e-5). Attention is
`scaled_dot_product_attention`, as the JAX side uses
jax.nn.dot_product_attention outside any Pallas kernel. Images are
channels-last [B, H, W, C]. Unlike flax, the port's modules are sized at
construction, so the image tower takes the input `image_size` (its
attention pool's positional embedding has one row per output cell + 1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv, Dense, LayerNorm, _compute_dtype, avg_pool
from .tokenizer import VOCAB_SIZE


class FrozenBatchNorm(nn.Module):
    """Inference-mode BN: `scale`, `bias`, running `mean` and `var` are
    parameters (loaded, never updated)."""

    epsilon = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.mean = nn.Parameter(torch.zeros(num_features))
        self.var = nn.Parameter(torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(None, x, self.scale)     # flax promotes here
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return x.to(dt) * inv.to(dt) + (self.bias - self.mean * inv).to(dt)


class Bottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: the stride is an average pool before
    conv3, and on the identity an average pool before the 1x1 projection."""

    expansion = 4

    def __init__(self, in_features: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv(in_features, planes, 1, use_bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, use_bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv(planes, out, 1, use_bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out)
        self.project = stride > 1 or in_features != out
        if self.project:
            self.downsample_conv = Conv(in_features, out, 1, use_bias=False,
                                        dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = avg_pool(out, self.stride, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.project:
            if self.stride > 1:
                identity = avg_pool(identity, self.stride, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return torch.relu(out + identity)


def _heads(y: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, heads*hd] -> [B, heads, T, hd]."""
    b, t, _ = y.shape
    return y.reshape(b, t, heads, -1).transpose(1, 2)


def _merge(y: torch.Tensor) -> torch.Tensor:
    """[B, heads, T, hd] -> [B, T, heads*hd]."""
    b, h, t, d = y.shape
    return y.transpose(1, 2).reshape(b, t, h * d)


class AttentionPool2d(nn.Module):
    """The mean token prepended to the [B, h*w, C] grid, a positional
    embedding added, one query from the mean token, attention over all
    tokens (scaled by 1/sqrt(head_dim)), projected to `output_dim`."""

    def __init__(self, n_tokens: int, embed_dim: int, num_heads: int = 32,
                 output_dim: int = 1024, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        inner = num_heads * (embed_dim // num_heads)
        self.positional_embedding = nn.Parameter(
            torch.zeros(n_tokens + 1, embed_dim))
        self.q = Dense(embed_dim, inner, dtype=dtype)
        self.k = Dense(embed_dim, inner, dtype=dtype)
        self.v = Dense(embed_dim, inner, dtype=dtype)
        self.out = Dense(inner, output_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        n = self.num_heads
        attn = F.scaled_dot_product_attention(
            _heads(self.q(tokens[:, :1]), n), _heads(self.k(tokens), n),
            _heads(self.v(tokens), n))
        return self.out(_merge(attn))[:, 0]


def _grid_size(image_size: int) -> int:
    """The side of ModifiedResNet's last stage for a square input: the
    stride-2 SAME stem conv, its 2x2 pool, then three stride-2 stages."""
    side = -(-image_size // 2) // 2
    for _ in range(3):
        side //= 2
    return side


class ModifiedResNet(nn.Module):
    """CLIP RN50 visual tower with pyramid taps: a 3-conv stem, four
    bottleneck stages and the attention pool."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, heads: int = 32,
                 image_size: int = 224, dtype: Optional[torch.dtype] = None):
        super().__init__()
        w = width
        kw = dict(use_bias=False, dtype=dtype)
        self.stem_conv1 = Conv(3, w // 2, 3, strides=2, **kw)
        self.stem_bn1 = FrozenBatchNorm(w // 2)
        self.stem_conv2 = Conv(w // 2, w // 2, 3, **kw)
        self.stem_bn2 = FrozenBatchNorm(w // 2)
        self.stem_conv3 = Conv(w // 2, w, 3, **kw)
        self.stem_bn3 = FrozenBatchNorm(w)
        self.stages = []
        inplanes = w
        for stage, (n_blocks, planes, stride) in enumerate(
                zip(layers, (w, w * 2, w * 4, w * 8), (1, 2, 2, 2))):
            blocks = []
            for i in range(n_blocks):
                blk = Bottleneck(inplanes, planes, stride if i == 0 else 1,
                                 dtype=dtype)
                self.add_module(f"layer{stage + 1}_{i}", blk)
                blocks.append(blk)
                inplanes = planes * Bottleneck.expansion
            self.stages.append(blocks)
        self.attnpool = AttentionPool2d(_grid_size(image_size) ** 2, inplanes,
                                        heads, output_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = torch.relu(self.stem_bn1(self.stem_conv1(x)))
        x = torch.relu(self.stem_bn2(self.stem_conv2(x)))
        x = torch.relu(self.stem_bn3(self.stem_conv3(x)))
        x = avg_pool(x, 2, 2)
        taps = []
        for blocks in self.stages:
            for blk in blocks:
                x = blk(x)
            taps.append(x)
        return (self.attnpool(x), *taps)


class TextTransformerBlock(nn.Module):
    """Pre-LN causal self-attention and a QuickGELU MLP."""

    def __init__(self, width: int = 512, heads: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        inner = heads * (width // heads)
        self.ln_1 = LayerNorm(width, dtype=dtype)
        self.q = Dense(width, inner, dtype=dtype)
        self.k = Dense(width, inner, dtype=dtype)
        self.v = Dense(width, inner, dtype=dtype)
        self.attn_out = Dense(inner, width, dtype=dtype)
        self.ln_2 = LayerNorm(width, dtype=dtype)
        self.mlp_fc = Dense(width, width * 4, dtype=dtype)
        self.mlp_proj = Dense(width * 4, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        n = self.heads
        attn = F.scaled_dot_product_attention(
            _heads(self.q(h), n), _heads(self.k(h), n), _heads(self.v(h), n),
            is_causal=True)
        x = x + self.attn_out(_merge(attn))
        h = self.mlp_fc(self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h)        # QuickGELU
        return x + self.mlp_proj(h)


class TextTransformer(nn.Module):
    """CLIP text tower: token + positional embedding, causal blocks,
    `ln_final`, the feature at the EOT token (the largest id), projected."""

    def __init__(self, vocab_size: int = VOCAB_SIZE,
                 context_length: int = 77, width: int = 512, heads: int = 8,
                 n_layers: int = 12, output_dim: int = 1024,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width))
        self.blocks = []
        for i in range(n_layers):
            blk = TextTransformerBlock(width, heads, dtype=dtype)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.ln_final = LayerNorm(width, dtype=dtype)
        self.text_projection = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        feats = x[torch.arange(x.shape[0], device=x.device), eot]
        return feats @ self.text_projection.to(feats.dtype)


class CLIPVisualEncoder(nn.Module):
    """Frozen RN50 image tower; its submodule is `visual`, as in flax. Size
    knobs default to RN50 at 224^2; tests shrink them."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, heads: int = 32,
                 image_size: int = 224, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.visual = ModifiedResNet(layers, width, output_dim, heads,
                                     image_size, dtype=dtype)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.visual(images)


class CLIPTextualEncoder(nn.Module):
    """Frozen text tower; its submodule is `text`, as in flax."""

    def __init__(self, width: int = 512, heads: int = 8, n_layers: int = 12,
                 output_dim: int = 1024, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.text = TextTransformer(width=width, heads=heads,
                                    n_layers=n_layers, output_dim=output_dim,
                                    dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)
