"""Alpha compositing (tcnerf/core/render.py)."""

from __future__ import annotations

import torch


def sigma_to_alpha(sigma: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """alpha = 1 - exp(-dist * relu(sigma))."""
    return 1.0 - torch.exp(-dists * torch.relu(sigma))


def volumetric_render(zs: torch.Tensor, density: torch.Tensor,
                      chromacity: torch.Tensor):
    """zs/density [B, R, S]; chromacity [B, R, S, 3].

    Returns (rgb [B, R, 3], depth [B, R], weights [B, R, S]). The last
    distance repeats the one before it; transmittance carries the +1e-10."""
    dists = zs[..., 1:] - zs[..., :-1]
    dists = torch.cat([dists, dists[..., -1:]], dim=-1)
    alpha = sigma_to_alpha(density, dists)
    one_minus = 1.0 - alpha + 1e-10
    transmittance = torch.cumprod(
        torch.cat([torch.ones_like(one_minus[..., :1]), one_minus[..., :-1]],
                  dim=-1), dim=-1)
    weights = alpha * transmittance
    rgb = (weights[..., None] * chromacity).sum(dim=-2)
    depth = (weights * zs).sum(dim=-1)
    return rgb, depth, weights
