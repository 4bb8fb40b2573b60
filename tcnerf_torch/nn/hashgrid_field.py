"""Hash-grid NeRF field (tcnerf/nn/hashgrid_field.py): the multiresolution
hash encoding of the positions (`ops/hashgrid.py`) and the directions,
through `n_layers` Dense + relu of `hidden_size`.

The renderer's per-scene fast field (`MVNeRFRenderer(field="hashgrid")`):
it reads no image features, so `features` / `features_projected` are taken
and ignored, as the embeddings' call is. Parameters: `hash_tables`
[n_levels, 2^T, F] (float32 whatever `dtype`; the encoding runs in f32) and
`layer_0` .. `layer_{n-1}`; the input is cast to `dtype` after the
encoding, as the flax module casts it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.hashgrid import HashGridConfig, hash_encode
from .layers import Dense


class HashGridField(nn.Module):
    def __init__(self, n_levels: int = 16, table_size_log2: int = 14,
                 features_per_level: int = 2, base_resolution: int = 16,
                 finest_resolution: int = 512,
                 bounds: Tuple[Tuple[float, float], ...] = (
                     (-0.2, 1.2), (-0.8, 0.8), (-0.4, 1.0)),
                 hidden_size: int = 64, n_layers: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = HashGridConfig(
            n_levels=n_levels, table_size_log2=table_size_log2,
            features_per_level=features_per_level,
            base_resolution=base_resolution,
            finest_resolution=finest_resolution,
            bounds=tuple(tuple(float(v) for v in b) for b in bounds))
        self.dtype = dtype
        self.hash_tables = nn.Parameter(torch.empty(
            n_levels, self.cfg.table_size, features_per_level))
        width = self.cfg.out_dim + 3
        for i in range(n_layers):
            self.add_module(f"layer_{i}", Dense(width, hidden_size,
                                                dtype=dtype))
            width = hidden_size
        self.n_layers = n_layers

    def forward(self, positions: torch.Tensor, directions: torch.Tensor,
                features=None, features_projected: bool = False
                ) -> torch.Tensor:
        """positions / directions [..., 3] -> embedding [..., hidden]."""
        enc = hash_encode(self.hash_tables, positions, self.cfg)
        x = torch.cat([enc, directions.to(enc.dtype)], dim=-1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"layer_{i}")(x))
        return x
