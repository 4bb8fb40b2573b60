"""Pinhole ray generation and training-pixel sampling (tcnerf/core/rays.py).

`extrinsics` is camera-to-world (the camera pose); pixel coordinates are
(u, v) = (column, row); `intrinsics` is the 3x3 (or padded 4x4) pinhole K.
The host-side (numpy) helpers feed the data layer: `get_specific_rays` and
`gather_target_rgb` are what tcnerf/utils/native.py's `rays_from_pixels`
and `gather_target_rgb` compute without their C++ (the port builds no host
C++).
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


def get_rays_np(image_width: int, image_height: int, extrinsics, intrinsics,
                norm_direction_vector: bool = True):
    """Host-side all-pixel rays: ([H, W, 3] origins, [H, W, 3] directions)."""
    u, v = np.meshgrid(np.arange(image_width, dtype=np.float32),
                       np.arange(image_height, dtype=np.float32),
                       indexing="xy")
    rays_o, rays_d = get_specific_rays(u.reshape(-1), v.reshape(-1),
                                       extrinsics, intrinsics,
                                       norm_direction_vector)
    shape = (image_height, image_width, 3)
    return rays_o.reshape(shape), rays_d.reshape(shape)


def gather_target_rgb(image: np.ndarray, pix: np.ndarray) -> np.ndarray:
    """uint8 image [H, W, C>=3] + [N, 2] (row, col) -> float32 [N, 3] in
    [0, 1]."""
    return (image[pix[:, 0], pix[:, 1], :3] / 255.0).astype(np.float32)


def bbox_biased_sample(rng, n_sample: int, bboxes, image_height: int,
                       image_width: int, in_box_p: float = 0.8) -> np.ndarray:
    """(row, col) pixel coords [n_sample, 2] int, an `in_box_p` share inside
    the box `bboxes` = (r0, c0, r1, c1), the rest anywhere in the image."""
    rng = (np.random.default_rng(rng)
           if not isinstance(rng, np.random.Generator) else rng)
    n_inside = int(n_sample * in_box_p)
    bboxes = np.asarray(bboxes)
    in_samples = rng.integers(bboxes[:2], bboxes[2:], (n_inside, 2))
    random_samples = rng.integers(0, (image_height, image_width),
                                  size=(n_sample - n_inside, 2))
    return np.concatenate([in_samples, random_samples], axis=0)


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
