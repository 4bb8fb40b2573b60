"""tcnerf_torch: the PyTorch + CUDA (Hopper) port of tcnerf.

Mirrors the layout of the JAX package (`core/`, `ops/`, `nn/`, `models/`)
so every counterpart is easy to find. Imports torch, numpy and the standard
library only. Public entry points run on `cuda` unless the caller passes
`device="cpu"` (see `tcnerf_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
