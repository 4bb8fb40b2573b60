"""Pinhole ray generation (tcnerf/core/rays.py).

`extrinsics` is camera-to-world (the camera pose); pixel coordinates are
(u, v) = (column, row); `intrinsics` is the 3x3 (or padded 4x4) pinhole K.
"""

from __future__ import annotations

import numpy as np
import torch


def get_specific_rays(u, v, extrinsics, intrinsics, norm_direction_vector=True):
    """Host-side (numpy) back-projection of pixels (u, v) into world rays.

    Returns (rays_o [N, 3], rays_d [N, 3]) float32. K^-1 is taken in float64.
    """
    u = np.asarray(u, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    pixels = np.stack((u, v, np.ones_like(u)), axis=0)
    k_inv = np.linalg.inv(np.asarray(intrinsics, dtype=np.float64)[:3, :3])
    rays_d = (np.asarray(extrinsics)[:3, :3] @ k_inv @ pixels).T.astype(np.float32)
    if norm_direction_vector:
        rays_d = rays_d / np.linalg.norm(rays_d, axis=1, keepdims=True)
    rays_o = np.broadcast_to(
        np.asarray(extrinsics, dtype=np.float32)[:3, -1], rays_d.shape)
    return rays_o, rays_d


def get_rays(image_width: int, image_height: int, extrinsics: torch.Tensor,
             intrinsics: torch.Tensor, norm_direction_vector: bool = True):
    """Device-side all-pixel rays: ([H, W, 3] origins, [H, W, 3] directions).

    Counterpart of `get_rays_jax`: K^-1 is inverted in float32 and every
    product runs in full fp32 (core/prec.py)."""
    dev = extrinsics.device
    v, u = torch.meshgrid(
        torch.arange(image_height, dtype=torch.float32, device=dev),
        torch.arange(image_width, dtype=torch.float32, device=dev),
        indexing="ij")
    pixels = torch.stack([u, v, torch.ones_like(u)], dim=-1)   # [H, W, 3]
    k_inv = torch.linalg.inv(intrinsics[:3, :3].float())
    rays_d = torch.einsum("ij,jk,hwk->hwi", extrinsics[:3, :3].float(), k_inv,
                          pixels)
    if norm_direction_vector:
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = extrinsics[:3, 3].float().expand(rays_d.shape)
    return rays_o, rays_d
