"""Stratified and hierarchical (inverse-CDF) sampling along rays
(tcnerf/core/sampling.py).

Both functions take their uniforms as optional explicit inputs (`u_jitter`,
`u_pdf`) so tests can feed JAX's draws; otherwise they draw from the given
`torch.Generator` (or the default one).
"""

from __future__ import annotations

from typing import Optional

import torch


def _uniform(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def sample_along_ray(rays_origin: torch.Tensor, rays_direction: torch.Tensor,
                     near: float, far: float, n_samples: int,
                     u_jitter: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """Uniform bins over [near, far) with per-bin jitter.

    rays_origin/rays_direction: [B, R, 3]. Returns
    (world_points [B, R, S, 3], z [B, R, S])."""
    b, r = rays_origin.shape[:2]
    step = (far - near) / n_samples
    lower = near + step * torch.arange(n_samples, dtype=rays_origin.dtype,
                                       device=rays_origin.device)
    if u_jitter is None:
        u_jitter = _uniform((b, r, n_samples), rays_origin, generator)
    z = lower[None, None, :] + u_jitter.to(rays_origin.dtype) * step
    world_points = (rays_origin[:, :, None, :]
                    + z[..., None] * rays_direction[:, :, None, :])
    return world_points, z


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u_pdf: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF resampling of `n_samples` z values from a piecewise PDF.

    bins: [B, R, Nb] sorted bin centres; weights: [B, R, Nb]. Keeps the
    reference's +1e-5 weights, zero-sum guard, integer compare-count CDF
    inversion, clamps and `denom < 1e-5` guard. Returns [B, R, n_samples]."""
    stable = weights + 1e-5
    w_sum = stable.sum(dim=-1, keepdim=True)
    w_sum = torch.where(w_sum.abs() == 0, torch.ones_like(w_sum), w_sum)
    pdf = stable / w_sum
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B,R,Nb+1]

    if u_pdf is None:
        u_pdf = _uniform(bins.shape[:2] + (n_samples,), bins, generator)
    u = u_pdf.to(bins.dtype)
    # above[i] = #(cdf entries <= u_i)
    above = (u[..., :, None] >= cdf[..., None, :]).to(torch.int64).sum(-1)

    nb = bins.shape[-1]
    below = torch.clamp(above - 1, 0, nb - 1)
    above_cdf = torch.clamp(above, 0, cdf.shape[-1] - 1)
    above_bins = torch.clamp(above, 0, nb - 1)

    cdf_a = torch.gather(cdf, -1, above_cdf)
    cdf_b = torch.gather(cdf, -1, below)
    bins_a = torch.gather(bins, -1, above_bins)
    bins_b = torch.gather(bins, -1, below)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
