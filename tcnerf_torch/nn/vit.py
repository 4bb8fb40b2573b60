"""Vision Transformer (ViT-B/16) with hooked hidden states and the
DPT-style decoder (tcnerf/nn/vit.py).

Kept from the JAX package: true LayerNorm (eps 1e-5), exact GELU, the second
residual adding the block INPUT (reference layers.py:88-95), and
jax.image.resize's bilinear resampling (antialiased when shrinking; see
layers.resize_bilinear). Attention is `scaled_dot_product_attention`, as
the JAX side uses jax.nn.dot_product_attention outside any Pallas kernel.
Images are channels-last [B, H, W, C].
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .conv import ConvolutionalEncoder
from .layers import Conv, ConvTranspose, Dense, LayerNorm, resize_bilinear


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 in_features: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Conv(in_features, embed_dim, patch_size,
                         strides=patch_size, padding="VALID", dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class TransformerBlock(nn.Module):
    """q/k/v are Dense(D -> heads*head_dim) with output index h*head_dim+d
    (flax DenseGeneral's [D, heads, head_dim] kernel, flattened)."""

    def __init__(self, num_heads: int = 12, embed_dim: int = 768,
                 mlp_ratio: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.norm_1 = LayerNorm(embed_dim, epsilon=1e-5, dtype=dtype)
        self.q = Dense(embed_dim, embed_dim, dtype=dtype)
        self.k = Dense(embed_dim, embed_dim, dtype=dtype)
        self.v = Dense(embed_dim, embed_dim, dtype=dtype)
        self.attn_out = Dense(embed_dim, embed_dim, dtype=dtype)
        self.norm_2 = LayerNorm(embed_dim, epsilon=1e-5, dtype=dtype)
        self.mlp_0 = Dense(embed_dim, embed_dim * mlp_ratio, dtype=dtype)
        self.mlp_1 = Dense(embed_dim * mlp_ratio, embed_dim, dtype=dtype)

    def forward(self, inputs):
        x = self.norm_1(inputs)
        b, t, d = x.shape

        def heads(y):                      # [B, T, D] -> [B, N, T, Dh]
            return y.reshape(b, t, self.num_heads, -1).transpose(1, 2)

        attn = F.scaled_dot_product_attention(heads(self.q(x)),
                                              heads(self.k(x)),
                                              heads(self.v(x)))
        attn = self.attn_out(attn.transpose(1, 2).reshape(b, t, d))
        x = inputs + attn
        y = self.mlp_1(F.gelu(self.mlp_0(self.norm_2(x))))
        return inputs + y                  # block input, reference quirk


class VisionTransformer(nn.Module):
    def __init__(self, img_size: Tuple[int, int] = (224, 224),
                 patch_size: int = 16, embed_dim: int = 768,
                 mlp_ratio: int = 4, num_heads: int = 12,
                 hooks: Sequence[int] = (3, 6, 9, 12),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.hooks = tuple(hooks)
        self.grid_size = (img_size[0] // patch_size, img_size[1] // patch_size)
        n_tokens = self.grid_size[0] * self.grid_size[1] + 1
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_tokens, embed_dim))
        self.blocks = []
        for i in range(self.hooks[-1]):
            blk = TransformerBlock(num_heads, embed_dim, mlp_ratio, dtype=dtype)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)

    def forward(self, images):
        x = self.patch_embed(images)
        b = x.shape[0]
        x = x.reshape(b, -1, self.embed_dim)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        features = []
        prev = 0
        for hook in self.hooks:
            for blk in self.blocks[prev:hook]:
                x = blk(x)
            prev = hook
            features.append(x)
        return x, features


class VisionTransformerEncoder(nn.Module):
    """DPT-style decoder over the 4 hooked ViT feature maps."""

    def __init__(self, img_size: Tuple[int, int] = (224, 224),
                 patch_size: int = 16, embed_dim: int = 768,
                 n_features: int = 256, mlp_ratio: int = 4,
                 num_heads: int = 12, hooks: Sequence[int] = (3, 6, 9, 12),
                 features: Sequence[int] = (48, 96, 192, 384),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = features
        kw = dict(dtype=dtype)
        self.vit = VisionTransformer(img_size, patch_size, embed_dim,
                                     mlp_ratio, num_heads, hooks, **kw)
        self.pp1_conv = Conv(embed_dim, f[0], 1, **kw)
        self.pp1_deconv = ConvTranspose(f[0], f[0], 4, 4, **kw)
        self.pp2_conv = Conv(embed_dim, f[1], 1, **kw)
        self.pp2_deconv = ConvTranspose(f[1], f[1], 2, 2, **kw)
        self.pp3_conv = Conv(embed_dim, f[2], 1, **kw)
        self.pp4_conv = Conv(embed_dim, f[3], 1, **kw)
        self.pp4_down = Conv(f[3], f[3], 3, strides=2, **kw)
        for i, c in enumerate(f):
            self.add_module(f"decode_{i + 1}",
                            Conv(c, n_features, 3, use_bias=False, **kw))
        self.out_conv_1 = Conv(4 * n_features, n_features, 3, **kw)
        self.out_conv_2 = Conv(n_features, n_features // 2, 3, **kw)

    def forward(self, images):
        _, feats = self.vit(images)
        gh, gw = self.vit.grid_size
        maps = [t[:, 1:].reshape(t.shape[0], gh, gw, t.shape[-1])
                for t in feats]
        f0 = self.pp1_deconv(self.pp1_conv(maps[0]))
        f1 = self.pp2_deconv(self.pp2_conv(maps[1]))
        f2 = self.pp3_conv(maps[2])
        f3 = self.pp4_down(self.pp4_conv(maps[3]))

        def decode_up(x, scale, conv):
            x = conv(x)
            return resize_bilinear(x, (x.shape[1] * scale, x.shape[2] * scale))

        latents = torch.cat([decode_up(f0, 2, self.decode_1),
                             decode_up(f1, 4, self.decode_2),
                             decode_up(f2, 8, self.decode_3),
                             decode_up(f3, 16, self.decode_4)], dim=-1)
        x = torch.relu(self.out_conv_1(torch.relu(latents)))
        return self.out_conv_2(x)


class VisualFeatures(nn.Module):
    """ViT path (resized to vit_size, decoded, resized to half the original
    size) concatenated with the conv path: [B, H/2, W/2, n_features]."""

    def __init__(self, n_features: int = 256,
                 original_image_size: Tuple[int, int] = (480, 640),
                 vit_size: Tuple[int, int] = (224, 224), patch_size: int = 16,
                 embed_dim: int = 768, num_heads: int = 12,
                 hooks: Sequence[int] = (3, 6, 9, 12),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.original_image_size = tuple(original_image_size)
        self.vit_size = tuple(vit_size)
        self.vision_transformer = VisionTransformerEncoder(
            img_size=vit_size, patch_size=patch_size, embed_dim=embed_dim,
            n_features=n_features, num_heads=num_heads, hooks=hooks,
            dtype=dtype)
        self.conv_features = ConvolutionalEncoder(n_features, dtype=dtype)

    def forward(self, images):
        latents = self.vision_transformer(resize_bilinear(images, self.vit_size))
        half = (self.original_image_size[0] // 2,
                self.original_image_size[1] // 2)
        latents = resize_bilinear(latents, half)
        skip = self.conv_features(images)
        return torch.cat([latents, skip], dim=-1)       # promotes, as jnp
