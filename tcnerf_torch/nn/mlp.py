"""NeRF embedding MLPs (tcnerf/nn/mlp.py): the single-view
`ResNetMLPEmbedding` and `MVResNetMLPEmbedding`, with mid-network
multi-view mean fusion.

The multi-view input layout is view-major: the leading axis is
(batch * n_views); after the `n_blocks // 2` feature blocks the stream is
mean-reduced over views and the fusion blocks continue on the fused stream.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.encoding import positional_encoding
from ..ops.resmlp import pack_chain, resmlp_rows_diff
from .blocks import ResNetMLPBlock
from .layers import Dense, _compute_dtype


class SliceableDense(Dense):
    """`Dense` whose weight splits at input column `split`:

      * `project_tail(img)` applies the feature slice (columns [split:], no
        bias) to a full-resolution feature image before the bilinear gather
        (gather/lerp and the product are both linear and commute);
      * `apply_head(x)` applies the pos/dir-encoding slice plus the bias.
    """

    def __init__(self, in_features: int, features: int, split: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, features, dtype=dtype)
        self.split = split

    def project_tail(self, images: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, images, self.weight)
        return images.to(dt) @ self.weight[:, self.split:].t().to(dt)

    def apply_head(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        return x.to(dt) @ self.weight[:, :self.split].t().to(dt) \
            + self.bias.to(dt)


def encode_pos_dir(positions, directions, n_freq: int, freq: float,
                   embed_direction_vector: bool) -> torch.Tensor:
    """The Fourier encoding of the positions, then that of the directions
    (`embed_direction_vector`) or the raw directions."""
    enc_d = (positional_encoding(directions, n_freq, freq)
             if embed_direction_vector else directions)
    return torch.cat([positional_encoding(positions, n_freq, freq), enc_d],
                     dim=-1)


class ResNetMLPEmbedding(nn.Module):
    """Single-view NeRF MLP: the Fourier encodings of positions (and of
    directions with `embed_direction_vector`, else the raw directions) and
    the `n_input_features` per-sample features, through `layer_0` and
    `n_blocks` residual blocks `block_<i>` (glorot-uniform kernels, as the
    flax module's). Returns the last activation, or with
    `complete_output` the list [layer_0, block_0, ..., block_<n-1>]."""

    def __init__(self, n_input_features: int, n_blocks: int = 6,
                 hidden_size: int = 128, n_freq: int = 10,
                 pos_encoding_freq: float = math.pi,
                 embed_direction_vector: bool = False,
                 complete_output: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_freq = n_freq
        self.pos_encoding_freq = pos_encoding_freq
        self.embed_direction_vector = embed_direction_vector
        self.complete_output = complete_output
        pd = 6 * n_freq + (6 * n_freq if embed_direction_vector else 3)
        self.layer_0 = Dense(pd + n_input_features, hidden_size, dtype=dtype)
        self.blocks = []
        for i in range(n_blocks):
            blk = ResNetMLPBlock(hidden_size, hidden_size, hidden_size,
                                 kernel_initializer="glorot_uniform",
                                 dtype=dtype)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)

    def forward(self, positions, directions, features):
        enc = encode_pos_dir(positions, directions, self.n_freq,
                             self.pos_encoding_freq,
                             self.embed_direction_vector)
        outputs = [self.layer_0(torch.cat([enc, features], dim=-1))]
        for block in self.blocks:
            outputs.append(block(outputs[-1]))
        return outputs if self.complete_output else outputs[-1]


class MVResNetMLPEmbedding(nn.Module):
    """Multi-view NeRF MLP with mean view fusion.

    `n_input_features` is the raw per-sample feature width (n_features + 3
    RGB); layer_0 is always a `SliceableDense` (the flax parameter tree is
    the same with and without the slice). `use_pallas` runs both chain
    halves through `resmlp_rows_diff` (K1', ops/resmlp.py): the fused kernel
    forward on the card, from bf16 copies of the weights whatever the model
    dtype, and a backward through the plain chain. `pack_builds` counts how
    often the kernel's packed weights were (re)built."""

    def __init__(self, n_input_features: int, n_blocks: int = 6,
                 hidden_size: int = 128, n_views: int = 2, n_freq: int = 10,
                 pos_encoding_freq: float = math.pi,
                 embed_direction_vector: bool = False,
                 complete_output: bool = False, use_pallas: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_views = n_views
        self.n_freq = n_freq
        self.pos_encoding_freq = pos_encoding_freq
        self.embed_direction_vector = embed_direction_vector
        self.complete_output = complete_output
        self.use_pallas = use_pallas
        self.pack_builds = 0
        pd = 6 * n_freq + (6 * n_freq if embed_direction_vector else 3)
        self.layer_0 = SliceableDense(pd + n_input_features, hidden_size,
                                      split=pd, dtype=dtype)
        n_feature = n_blocks // 2
        self.feature_blocks = []
        self.fusion_blocks = []
        for i in range(n_blocks):
            blk = ResNetMLPBlock(hidden_size, hidden_size, hidden_size,
                                 dtype=dtype)
            if i < n_feature:
                self.add_module(f"feature_block_{i}", blk)
                self.feature_blocks.append(blk)
            else:
                self.add_module(f"fusion_block_{i - n_feature}", blk)
                self.fusion_blocks.append(blk)

    def encode_pos_dir(self, positions, directions):
        return encode_pos_dir(positions, directions, self.n_freq,
                              self.pos_encoding_freq,
                              self.embed_direction_vector)

    def project_image(self, images):
        return self.layer_0.project_tail(images)

    def forward(self, positions, directions, features,
                features_projected: bool = False):
        enc = self.encode_pos_dir(positions, directions)
        if features_projected:
            head = self.layer_0.apply_head(enc)
            x = head + features.to(head.dtype)
        else:
            x = self.layer_0(torch.cat([enc, features], dim=-1))
        if self.use_pallas and not self.complete_output:
            return self._pallas_chain(x)
        outputs = [x]
        for block in self.feature_blocks:
            outputs.append(block(outputs[-1]))
        pre = outputs[-1]
        outputs.append(
            pre.reshape((-1, self.n_views) + pre.shape[1:]).mean(dim=1))
        for block in self.fusion_blocks:
            outputs.append(block(outputs[-1]))
        return outputs if self.complete_output else outputs[-1]

    def _chain_flat(self, blocks, dt):
        out = []
        for blk in blocks:
            for layer in (blk.layer_0, blk.layer_1):
                out += [layer.weight.t().to(dt), layer.bias.to(dt)]
        return out

    def _chain_packs(self, flats, dt):
        """The kernel's packed weights of both halves, built once and again
        only when a parameter is replaced or changed in place (an optimizer
        step moves every parameter's `_version`: one build per step)."""
        key = (dt, tuple((p.data_ptr(), p._version) for p in self.parameters()))
        if getattr(self, "_packs_key", None) != key:
            dev = next(self.parameters()).device
            with torch.no_grad():
                self._packs = tuple(pack_chain(f, len(f) // 4,
                                               skip_input=True, device=dev)
                                    for f in flats)
            self._packs_key = key
            self.pack_builds += 1
        return self._packs

    def _pallas_chain(self, x):
        """Both chain halves through K1' (differentiable), with the mean view
        fusion between them; the stream is f32 inside the kernel."""
        dt = x.dtype
        flats = [self._chain_flat(self.feature_blocks, dt),
                 self._chain_flat(self.fusion_blocks, dt)]
        packs = self._chain_packs(flats, dt) if x.is_cuda else (None, None)
        shape = x.shape
        h1 = resmlp_rows_diff(x.reshape(-1, shape[-1]).contiguous(),
                              flats[0], len(self.feature_blocks),
                              skip_input=True, pack=packs[0]).reshape(shape)
        fused = h1.reshape((-1, self.n_views) + shape[1:]).mean(dim=1)
        h2 = resmlp_rows_diff(fused.reshape(-1, shape[-1]).contiguous(),
                              flats[1], len(self.fusion_blocks),
                              skip_input=True, pack=packs[1])
        return h2.reshape(fused.shape)
