"""Multiresolution hash-grid encoding (tcnerf/ops/hashgrid.py).

Per level, each point's cell in a grid of `scale` cells per unit,
the spatial hash of the cell's 8 corners into a table of 2^T rows of F
features, and the trilinear blend of the corners' features:

    tables = init_hash_params(generator, cfg)     # [L, 2^T, F]
    features = hash_encode(tables, x, cfg)        # x [..., 3] -> [..., L * F]

`x` is normalized to the unit cube by `cfg.bounds` and clipped to it. The
levels run in groups of at most 2^20 / N levels: one after another from
2^20 points on, as the JAX function's `lax.map` runs them, so that outside
autograd the live temporaries are never more than one level's at 2^20
points; a small chunk (a 512- or 128-ray chunk of 64 samples) takes all
its levels at once, in ~20 launches instead of ~20 per level.

Two things keep the port on the JAX function's table rows. The level
scales are JAX's f32 bits: `level_scales` computes them on the CPU in f32
(torch's CPU pow rounds as XLA's does; numpy's and a float64 computation
do not), and in f64 for f64 points, as JAX does under x64. The hash is
uint32 arithmetic that wraps; here each axis' product is taken in int64
and masked to 32 bits before the xor, which is the same number.

The encoding is plain PyTorch, as the JAX package's is plain jnp: no
kernel. It is twice differentiable in the points (through the trilinear
weights; `floor` and the clip's outside carry no gradient) and in the
tables (through the gather), which the delta-NGF step needs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ..core.bounds import clip

_PRIMES = (1, 2654435761, 805459861)   # instant-NGP spatial-hash primes
_MASK = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    table_size_log2: int = 14
    features_per_level: int = 2
    base_resolution: int = 16
    finest_resolution: int = 512
    bounds: Tuple[Tuple[float, float], ...] = (
        (0.35, 0.85), (-0.25, 0.25), (0.0, 0.2))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features_per_level

    @property
    def table_size(self) -> int:
        return 2 ** self.table_size_log2

    def level_scales(self, dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
        """[n_levels] cells per unit, base * growth^l, on the CPU in
        `dtype` (float32, or float64 for f64 points)."""
        if self.n_levels == 1:
            return torch.tensor([float(self.base_resolution)], dtype=dtype)
        growth = (self.finest_resolution / self.base_resolution) ** (
            1.0 / (self.n_levels - 1))
        return self.base_resolution * torch.tensor(growth, dtype=dtype) ** \
            torch.arange(self.n_levels, dtype=dtype)


def init_hash_params(generator: torch.Generator, cfg: HashGridConfig,
                     device=None) -> torch.Tensor:
    """[n_levels, 2^T, F] uniform in +-1e-4 (instant-NGP's init), drawn
    from `generator` (on `device`, default the generator's)."""
    shape = (cfg.n_levels, cfg.table_size, cfg.features_per_level)
    u = torch.rand(shape, generator=generator,
                   device=device or generator.device)
    return (2 * u - 1) * 1e-4


def _axis_hash(c: torch.Tensor, axis: int) -> torch.Tensor:
    """One axis' term of the hash: c * prime mod 2^32 (int64 in, int64
    in [0, 2^32) out; c * prime < 2^63 for c < 2^31 / 1.3)."""
    return (c * _PRIMES[axis]) & _MASK


def _hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of integer corner coords [..., 3] -> [...] int64 in
    [0, table_size): the uint32 xor of the axes' wrapped products."""
    c = coords.long()
    h = (_axis_hash(c[..., 0], 0) ^ _axis_hash(c[..., 1], 1)
         ^ _axis_hash(c[..., 2], 2))
    return h % table_size


def _levels(tables: torch.Tensor, flat: torch.Tensor, scales: torch.Tensor,
            base: torch.Tensor, table_size: int, corners: torch.Tensor,
            primes: torch.Tensor) -> torch.Tensor:
    """G levels at once: tables [G, 2^T, F], points in the unit cube
    [N, 3], scales [G], `base` [>= G, 1] = each level's first row in the
    flattened tables -> features [N, G, F]. `corners` [2] = (0, 1) and
    `primes` [3, 1] (int64) build each axis' two corner coordinates and
    their hash terms at once; the 8 corners (i, j, k), i the outermost as
    JAX's offsets, are the broadcast xor of those terms."""
    n, g = flat.shape[0], scales.shape[0]
    p = flat[:, None, :] * scales[:, None]          # [N, G, 3]
    p0 = torch.floor(p)
    frac = p - p0                                   # the gradient's path
    h = ((p0.long()[..., None] + corners) * primes) & _MASK  # [N, G, 3, 2]
    idx = (h[..., 0, :, None, None] ^ h[..., 1, None, :, None]
           ^ h[..., 2, None, None, :]).reshape(n, g, 8) % table_size
    w = torch.stack([1.0 - frac, frac], dim=-1)     # [N, G, 3, 2]
    weights = (w[..., 0, :, None, None] * w[..., 1, None, :, None]
               * w[..., 2, None, None, :]).reshape(n, g, 8)
    rows = idx + base[:g]
    feats = tables.reshape(-1, tables.shape[-1])[rows]      # [N, G, 8, F]
    return torch.sum(feats * weights[..., None], dim=2)


# points x levels per group of levels: the live temporaries of one group
# are those of one level at 2^20 points (~0.3 GB), as the JAX function's
# lax.map bounds them
_GROUP = 2 ** 20


@functools.lru_cache(maxsize=64)
def _constants(cfg: HashGridConfig, dtype: torch.dtype, device: torch.device):
    """(the box's low corner [3], the reciprocal of its size [3], the
    level scales [L] in `dtype`; each level's first row in the flattened
    tables [L, 1], the corner offsets (0, 1) and the primes [3, 1] in
    int64), computed once on the CPU and moved to `device`; only read
    afterwards. Made outside inference mode, so that a first call under
    it (a render) leaves tensors autograd can save."""
    with torch.inference_mode(False):
        bounds = torch.tensor(cfg.bounds, dtype=dtype)
        inv = 1.0 / (bounds[:, 1] - bounds[:, 0])
        return tuple(t.to(device) for t in (
            bounds[:, 0], inv, cfg.level_scales(dtype),
            torch.arange(cfg.n_levels)[:, None] * cfg.table_size,
            torch.arange(2), torch.tensor(_PRIMES)[:, None]))


def hash_encode(tables: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """Encode points x [..., 3] -> [..., n_levels * F]. The points are
    taken in f32 (f64 for f64 points), as JAX promotes them with its f32
    bounds."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    lo, inv, scales, base, corners, primes = _constants(cfg, dtype,
                                                         x.device)
    # times the reciprocal of the box's size: XLA compiles the JAX
    # function's division by its constant bounds so (1 ulp apart in u)
    u = (x.to(dtype) - lo) * inv
    flat = clip(u, 0.0, 1.0).reshape(-1, 3)
    step = max(1, _GROUP // max(flat.shape[0], 1))
    encoded = torch.cat([
        _levels(tables[l:l + step], flat, scales[l:l + step], base,
                cfg.table_size, corners, primes)
        for l in range(0, cfg.n_levels, step)], dim=1)   # [N, L, F]
    return encoded.reshape(x.shape[:-1] + (cfg.out_dim,))
