"""Geometric error helpers (tcnerf/tasks/transform_utils/differences.py,
after the reference's transform_utils/differences.py:5-58)."""

from __future__ import annotations

import numpy as np

from ..transform import Affine


def rotation_to_line_difference(rotation, line_point_a, line_point_b):
    """Rotational error of a frame's x-axis to a line; returns (error_rad, cos)."""
    x_axis = (Affine(rotation=rotation) * Affine(translation=(1, 0, 0))).translation
    direction = np.asarray(line_point_b) - np.asarray(line_point_a)
    direction = direction / np.linalg.norm(direction)
    cos = float(np.clip(np.dot(x_axis, direction), -1.0, 1.0))
    return np.arccos(np.abs(cos)), cos


def point_to_segment_distance(point, line_point_a, line_point_b):
    """Euclidean distance from a point to a line segment."""
    point = np.asarray(point, dtype=np.float64)
    a = np.asarray(line_point_a, dtype=np.float64)
    b = np.asarray(line_point_b, dtype=np.float64)
    ab = b - a
    denom = float(np.dot(ab, ab))
    if denom < 1e-18:
        return float(np.linalg.norm(point - a))
    t = np.clip(np.dot(point - a, ab) / denom, 0.0, 1.0)
    return float(np.linalg.norm(point - (a + t * ab)))


def project_point_on_plane(point, plane_point, plane_normal):
    """Project a point onto a plane; returns (projection, signed_distance).

    Reference manipulation_tasks/geometric_utils.py:4-9 — the signed distance
    is along the (normalized) plane normal from the point TO the plane.
    """
    point = np.asarray(point, dtype=np.float64)
    plane_point = np.asarray(plane_point, dtype=np.float64)
    normal = np.asarray(plane_normal, dtype=np.float64)
    normal = normal / np.linalg.norm(normal)
    distance = float(np.dot(plane_point - point, normal))
    return point + distance * normal, distance


def triangle_area(a, b, c):
    """Area of the 3D triangle (a, b, c) (reference geometric_utils.py:12)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    return 0.5 * float(np.linalg.norm(np.cross(b - a, c - a)))


def transformation_difference(pose_a: Affine, pose_b: Affine):
    """(translational, rotational) difference between two Affine poses."""
    translation_error = float(np.linalg.norm(pose_a.translation - pose_b.translation))
    rotation_error = float(np.linalg.norm((pose_a.invert() * pose_b).axis_angle))
    return translation_error, rotation_error
