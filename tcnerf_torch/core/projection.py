"""World <-> camera projection for multi-view conditioning
(tcnerf/core/projection.py). Full fp32 (core/prec.py)."""

from __future__ import annotations

import torch

from .bounds import clip

PIXEL_CLIP = 1e6
Z_EPS = 1e-8


def project_points_mv(world_points: torch.Tensor, src_intrinsics: torch.Tensor,
                      src_extrinsics_inv: torch.Tensor):
    """world_points [B, R, S, 3]; intrinsics / extrinsics_inv [B, V, 4, 4].

    Returns (pixel_xy [B, V, R, S, 2], camera_points [B, V, R, S, 4])."""
    wph = torch.cat([world_points, torch.ones_like(world_points[..., :1])], -1)
    cam = torch.einsum("bvij,brsj->bvrsi", src_extrinsics_inv, wph)
    proj = torch.einsum("bvij,bvrsj->bvrsi", src_intrinsics, cam)
    pixel_xy = proj[..., :2] / clip(proj[..., 2:3], Z_EPS)
    pixel_xy = clip(pixel_xy, -PIXEL_CLIP, PIXEL_CLIP)
    return pixel_xy, cam


def world_to_camera_directions_mv(world_dirs: torch.Tensor,
                                  src_extrinsics_inv: torch.Tensor) -> torch.Tensor:
    """world_dirs [B, R, 3] -> camera-frame directions [B, V, R, 3].

    Keeps the reference's w=1 quirk: directions are homogenised with w=1,
    so the translation leaks into them (nerf_utils.py:95-104)."""
    dh = torch.cat([world_dirs, torch.ones_like(world_dirs[..., :1])], -1)
    cam = torch.einsum("bvij,brj->bvri", src_extrinsics_inv, dh)
    return cam[..., :3]


def project_probe_points(points: torch.Tensor, src_intrinsics: torch.Tensor,
                         src_extrinsics_inv: torch.Tensor):
    """Grasp-probe translations [B, N, P, 3] into each view.

    Returns (pixel_xy [B, V, N, P, 2], camera_points [B, V, N, P, 3])."""
    ph = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    cam = torch.einsum("bvij,bnpj->bvnpi", src_extrinsics_inv, ph)
    proj = torch.einsum("bvij,bvnpj->bvnpi", src_intrinsics, cam)
    pixel_xy = proj[..., :2] / clip(proj[..., 2:3], Z_EPS)
    pixel_xy = clip(pixel_xy, -PIXEL_CLIP, PIXEL_CLIP)
    return pixel_xy, cam[..., :3]


def rotate_directions(rotations: torch.Tensor, direction: torch.Tensor,
                      src_extrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Probe axis directions into camera frames, with the reference's w=1
    quirk. rotations [B, N, P, 3, 3]; direction [3]; extrinsics_inv
    [B, V, 4, 4] -> [B, V, N, P, 3]."""
    d = torch.einsum("bnpij,j->bnpi", rotations, direction)
    dh = torch.cat([d, torch.ones_like(d[..., :1])], -1)
    cam = torch.einsum("bvij,bnpj->bvnpi", src_extrinsics_inv, dh)
    return cam[..., :3]
