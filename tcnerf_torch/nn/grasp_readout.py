"""Grasp energy readout head (tcnerf/nn/grasp_readout.py).

Input: the fused-stream activations of the NeRF MLP, each [B, N, P, H]
(N poses, P probe points, H hidden). Each of the first four gets its own
Dense(64) downscale and the activation; the downscales are concatenated,
go through Dense(64) (flax's default initializer) and the activation,
the probes are flattened ([B, N, P * 64]), then `readout_block_0` (hidden
128, out 64, transformed shortcut), `readout_block_1` (64, 64) and
`readout_head` (relu -> Dense(1)) give one energy per pose. The relu
flavour (glorot) and the elu flavours (glorot or he_normal, with or without
the head's bias) differ in the activation, the initializer and the bias.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .blocks import Readout, ResNetMLPBlock, activation_fn
from .layers import Dense


class GraspReadout(nn.Module):
    def __init__(self, hidden_size: int, n_activations: int, n_probes: int,
                 use_bias: bool = True, activation: str = "relu",
                 kernel_initializer: str = "glorot_uniform",
                 activation_downscale: int = 64, extra_features: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation
        self.n_activations = min(n_activations, 4)
        kw = dict(dtype=dtype, kernel_init=kernel_initializer)
        for i in range(self.n_activations):
            self.add_module(f"activation_downscale_{i + 1}",
                            Dense(hidden_size, activation_downscale, **kw))
        n_streams = self.n_activations
        if extra_features:
            self.activation_downscale_extra = Dense(
                extra_features, activation_downscale, **kw)
            n_streams += 1
        self.extra_features = extra_features
        self.combined_activation_downscale = Dense(
            activation_downscale * n_streams, 64, dtype=dtype)
        block = dict(activation=activation,
                     kernel_initializer=kernel_initializer, dtype=dtype)
        self.readout_block_0 = ResNetMLPBlock(n_probes * 64, 128, 64,
                                              transform_shortcut=True, **block)
        self.readout_block_1 = ResNetMLPBlock(64, 64, 64, **block)
        self.readout_head = Readout(64, 1, use_bias=use_bias,
                                    kernel_initializer=kernel_initializer,
                                    dtype=dtype)

    def forward(self, activations: Sequence[torch.Tensor],
                extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """activations: each [B, N, P, H], extra [B, N, P, extra_features]
        (when the readout was built with the stream) -> energies [B, N]."""
        combined = self.probe_features(activations, extra)
        return self.pose_energies(
            combined.reshape(combined.shape[:-2] + (-1,)))

    def probe_features(self, activations: Sequence[torch.Tensor],
                       extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The per-probe part: the downscales, their activation, the
        combined Dense(64) and the activation -> [..., P, 64]."""
        if (extra is not None) != bool(self.extra_features):
            raise ValueError(f"the readout was built with extra_features="
                             f"{self.extra_features}; extra is "
                             f"{'given' if extra is not None else 'None'}")
        act = activation_fn(self.activation)
        ds = [act(getattr(self, f"activation_downscale_{i + 1}")(a))
              for i, a in enumerate(activations[:self.n_activations])]
        if extra is not None:
            ds.append(act(self.activation_downscale_extra(extra)))
        return act(self.combined_activation_downscale(torch.cat(ds, dim=-1)))

    def pose_energies(self, combined: torch.Tensor) -> torch.Tensor:
        """The per-pose part: [B, N, P * 64] -> energies [B, N]."""
        x = self.readout_block_1(self.readout_block_0(combined))
        return self.readout_head(x)[..., 0]
