"""Pose sampling from geometric primitives
(tcnerf/tasks/transform_utils/random.py, after the reference's
transform_utils/random.py)."""

from __future__ import annotations

import numpy as np

from ..transform import Affine


def sample_point_from_segment(point_a: Affine, point_b: Affine, rng=None) -> Affine:
    rng = np.random.default_rng(rng)
    r = rng.uniform()
    return Affine(translation=r * point_a.translation + (1 - r) * point_b.translation)


def _frame_along(direction: np.ndarray) -> np.ndarray:
    """Right-handed frame with x along `direction` and z as vertical as possible."""
    x_axis = direction / np.linalg.norm(direction)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(x_axis, up)) > 0.999:
        up = np.array([1.0, 0.0, 0.0])
    y_axis = np.cross(up, x_axis)
    y_axis /= np.linalg.norm(y_axis)
    z_axis = np.cross(x_axis, y_axis)
    return np.stack([x_axis, y_axis, z_axis], axis=1)


def sample_pose_from_segment(point_a: Affine, point_b: Affine, rng=None) -> Affine:
    """Position uniformly on the segment; x-axis parallel to it, z-axis up."""
    point = sample_point_from_segment(point_a, point_b, rng)
    direction = point_b.translation - point_a.translation
    if np.linalg.norm(direction) < 1e-12:
        return point
    return Affine(translation=point.translation, rotation=_frame_along(direction))


def sample_pose_from_rectangle(point_a: Affine, point_b: Affine,
                               point_c: Affine, point_d: Affine, rng=None) -> Affine:
    """Position uniformly inside the rectangle spanned a->b, a->d; x along a->b."""
    rng = np.random.default_rng(rng)
    u, v = rng.uniform(), rng.uniform()
    ab = point_b.translation - point_a.translation
    ad = point_d.translation - point_a.translation
    t = point_a.translation + u * ab + v * ad
    if np.linalg.norm(ab) < 1e-12:
        return Affine(translation=t)
    return Affine(translation=t, rotation=_frame_along(ab))
