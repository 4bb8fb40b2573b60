"""Bilinear feature gather at continuous pixel locations
(tcnerf/ops/interpolate.py).

Semantics of tfa.interpolate_bilinear(indexing='xy'): queries are (x, y) =
(column, row); the query is clamped into the grid, the floor is clamped to
[0, size-2], and the lerp fractions come from the clamped values.
"""

from __future__ import annotations

import torch

from ..core.bounds import clip


def _stencil(coords_xy: torch.Tensor, h: int, w: int):
    x = clip(coords_xy[..., 0], 0.0, w - 1.0)
    y = clip(coords_xy[..., 1], 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x), 0.0, w - 2.0)
    y0 = torch.clamp(torch.floor(y), 0.0, h - 2.0)
    ax = (x - x0)[..., None]
    ay = (y - y0)[..., None]
    idx = y0.long() * w + x0.long()
    return idx, ax, ay


def _lerp(v00, v01, v10, v11, ax, ay):
    top = v00 + ax * (v01 - v00)
    bottom = v10 + ax * (v11 - v10)
    return top + ay * (bottom - top)


def _take_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat [B, P, C], idx [B, N] -> [B, N, C]."""
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))


def bilinear_gather(images: torch.Tensor, coords_xy: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, C]; coords_xy [B, N, 2] (x, y) -> [B, N, C]."""
    b, h, w, c = images.shape
    idx, ax, ay = _stencil(coords_xy, h, w)
    flat = images.reshape(b, h * w, c)
    return _lerp(_take_rows(flat, idx), _take_rows(flat, idx + 1),
                 _take_rows(flat, idx + w), _take_rows(flat, idx + w + 1),
                 ax, ay)


def make_corner_image(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 4C]: each pixel stacked with its +x, +y and
    +x+y neighbours (edge-clamped)."""
    x1 = torch.cat([images[:, :, 1:], images[:, :, -1:]], dim=2)
    y1 = torch.cat([images[:, 1:], images[:, -1:]], dim=1)
    xy1 = torch.cat([x1[:, 1:], x1[:, -1:]], dim=1)
    return torch.cat([images, x1, y1, xy1], dim=-1)


def bilinear_gather_corners(corner_images: torch.Tensor,
                            coords_xy: torch.Tensor) -> torch.Tensor:
    """One gathered row per query from a `make_corner_image` image; the same
    stencil and lerp as `bilinear_gather`. Returns [B, N, C]."""
    b, h, w, c4 = corner_images.shape
    c = c4 // 4
    idx, ax, ay = _stencil(coords_xy, h, w)
    rows = _take_rows(corner_images.reshape(b, h * w, c4), idx)
    return _lerp(rows[..., :c], rows[..., c:2 * c], rows[..., 2 * c:3 * c],
                 rows[..., 3 * c:], ax, ay)


def gather_projection_features(normalized_images: torch.Tensor,
                               features: torch.Tensor,
                               pixel_xy: torch.Tensor) -> torch.Tensor:
    """RGB in [-1, 1] and a feature map sampled at projected pixels.

    normalized_images [B, V, H, W, 3]; features [B, V, H, W, C];
    pixel_xy [B, V, R, S, 2]. Returns [B, V, R, S, C+3]; RGB and features
    are gathered separately and concatenated."""
    b, v, h, w, _ = normalized_images.shape
    r, s = pixel_xy.shape[2], pixel_xy.shape[3]
    coords = pixel_xy.reshape(b * v, r * s, 2)
    rgb = bilinear_gather(normalized_images.reshape(b * v, h, w, 3), coords)
    feat = bilinear_gather(features.reshape(b * v, h, w, features.shape[-1]),
                           coords)
    out = torch.cat([rgb, feat], dim=-1)
    return out.reshape(b, v, r, s, out.shape[-1])
