"""SE(3) math on tensors (tcnerf/core/se3.py).

Quaternions are (x, y, z, w) throughout, as scipy's `Rotation.as_quat` and
the task layer (tasks/transform.py) have them. Every function works over
leading batch dimensions and is differentiable; geometry stays full fp32
(core/prec.py).
"""

from __future__ import annotations

import torch

from .bounds import clip


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / clip(torch.linalg.norm(v, dim=-1, keepdim=True), eps)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) xyzw -> rotation matrices (..., 3, 3); the
    quaternion is normalized first, so ascent over raw quaternions stays
    well defined."""
    q = _normalize(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def sixd_to_matrix(sixd: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> (..., 3, 3): the columns r1 = normalize(a),
    r2 = normalize(b) (not orthogonalized against r1, as the reference
    builds it) and r3 = r1 x r2."""
    r1 = _normalize(sixd[..., :3])
    r2 = _normalize(sixd[..., 3:])
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    return torch.stack([r1, r2, r3], dim=-1)


def make_homogeneous(translations: torch.Tensor,
                     rot_matrices: torch.Tensor) -> torch.Tensor:
    """(..., 3) translations and (..., 3, 3) rotations -> (..., 4, 4)."""
    top = torch.cat([rot_matrices, translations[..., :, None]], dim=-1)
    # made where `top` lives: a tensor from a host list would be a copy
    # from pageable memory, which waits for the card
    last = torch.zeros_like(top[..., :1, :])
    last[..., 3] = 1.0
    return torch.cat([top, last], dim=-2)


def pose_to_matrix(translations: torch.Tensor, rotations: torch.Tensor,
                   rotation_representation: str = "quaternion"
                   ) -> torch.Tensor:
    """(t, r) -> homogeneous matrices, r a quaternion or a 6D rotation."""
    if rotation_representation == "quaternion":
        rot = quat_to_matrix(rotations)
    elif rotation_representation == "6d":
        rot = sixd_to_matrix(rotations)
    else:
        raise ValueError(
            f"Unknown rotation representation: {rotation_representation}")
    return make_homogeneous(translations, rot)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) xyzw, w >= 0:
    the four Shepperd candidates, the one with the largest pivot kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], -1),
        torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20,
                     m21 - m12], -1),
        torch.stack([m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21,
                     m02 - m20], -1),
        torch.stack([m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11,
                     m10 - m01], -1)], dim=-2)
    scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], -1)
    choice = torch.argmax(scores, dim=-1)
    q = torch.gather(cands, -2, choice[..., None, None].expand(
        choice.shape + (1, 4)))[..., 0, :]
    q = _normalize(q)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def transform_points(matrices: torch.Tensor, points: torch.Tensor
                     ) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., 3) points."""
    return (torch.einsum("...ij,...j->...i", matrices[..., :3, :3], points)
            + matrices[..., :3, 3])
