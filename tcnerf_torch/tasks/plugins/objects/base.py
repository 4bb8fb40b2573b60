"""Scene/pick object plugins (tcnerf/tasks/plugins/objects/base.py, after
the reference's plugins/objects/base.py).

PickObject samples valid planar two-jaw gripper poses from configured
segments/rectangles and computes pose errors to each valid grasp area with
gripper rotational symmetries.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np

from ... import factory
from ...transform import Affine
from ...transform_utils.differences import (point_to_segment_distance,
                                            project_point_on_plane,
                                            rotation_to_line_difference,
                                            triangle_area)
from ...transform_utils.random import (sample_pose_from_rectangle,
                                       sample_pose_from_segment)


@dataclass
class SceneObject:
    urdf_path: str = None
    object_id: int = -1
    static: bool = True
    pose: Affine = field(default_factory=Affine)
    min_dist: float = 0.0
    offset: Affine = field(default_factory=Affine)
    unique_id: int = -1


@dataclass
class PickObject(SceneObject):
    """Object pickable along configured segments/rectangles (planar 2-jaw grasps)."""

    static: bool = False
    pick_config: List[Dict[str, Any]] = field(default_factory=list)

    def get_valid_poses(self) -> List[Affine]:
        rng = np.random.default_rng()
        area = self.pick_config[int(rng.integers(len(self.pick_config)))]
        if area["type"] == "segment":
            pose = sample_pose_from_segment(
                Affine(translation=area["point_a"]),
                Affine(translation=area["point_b"]), rng)
        elif area["type"] == "rectangle":
            pose = sample_pose_from_rectangle(
                Affine(translation=area["point_a"]),
                Affine(translation=area["point_b"]),
                Affine(translation=area["point_c"]),
                Affine(translation=area["point_d"]), rng)
        else:
            raise ValueError(f"No valid pose found for pick object {self}")
        return [pose]

    def compute_pose_errors(self, gripper_pose: Affine,
                            rotational_symmetries: int = 1) -> List[Tuple[float, float]]:
        """Pose error to each configured grasp area.

        Segments (reference plugins/objects/base.py:96-124): translational
        distance of the gripper to the a→b segment + rotational error of the
        gripper x-axis to the grasp line, modulo gripper symmetry.

        Rectangles (reference plugins/objects/base.py:125-187 +
        geometric_utils.py:4-12): project the gripper translation onto the
        (horizontal) rectangle plane; if the projection lies inside the
        rectangle (sum of the four projection-corner triangle areas equals the
        rectangle area) the translational error is the |plane distance|,
        otherwise the minimum distance to the four edges. Rotational error is
        the tilt of the gripper z-axis off the plane normal (symmetries do not
        apply — any planar yaw grasps a rectangle).
        """
        errors = []
        for area in self.pick_config:
            if area["type"] == "segment":
                a = (self.pose * Affine(translation=area["point_a"])).translation
                b = (self.pose * Affine(translation=area["point_b"])).translation
                t_error = point_to_segment_distance(gripper_pose.translation, a, b)
                if np.linalg.norm(b - a) < 1e-12:
                    r_error = 0.0
                else:
                    r_error, _ = rotation_to_line_difference(
                        gripper_pose.rotation, a, b)
                    if rotational_symmetries > 1:
                        period = np.pi / rotational_symmetries
                        r_error = min(r_error % (2 * period),
                                      abs((r_error % (2 * period)) - 2 * period))
                errors.append((float(t_error), float(r_error)))
            elif area["type"] == "rectangle":
                corners = [(self.pose * Affine(translation=area[k])).translation
                           for k in ("point_a", "point_b", "point_c", "point_d")]
                a, b, c, d = corners
                normal = np.array([0.0, 0.0, 1.0])
                projection, distance = project_point_on_plane(
                    gripper_pose.translation, a, normal)
                # convex rectangle: projection is inside iff the four
                # projection-corner triangles tile the rectangle exactly
                t_area = (triangle_area(projection, a, b)
                          + triangle_area(projection, b, c)
                          + triangle_area(projection, c, d)
                          + triangle_area(projection, d, a))
                r_area = triangle_area(a, b, c) + triangle_area(a, c, d)
                if abs(t_area - r_area) <= 3e-5:
                    t_error = abs(distance)
                else:
                    g = gripper_pose.translation
                    t_error = min(point_to_segment_distance(g, a, b),
                                  point_to_segment_distance(g, b, c),
                                  point_to_segment_distance(g, c, d),
                                  point_to_segment_distance(g, d, a))
                z_axis = gripper_pose.rotation @ normal
                cos = float(np.dot(z_axis, normal))
                sin = float(np.linalg.norm(np.cross(z_axis, normal)))
                r_error = abs(float(np.arctan2(sin, cos)))
                errors.append((float(t_error), r_error))
        return errors


@dataclass
class TargetObject(SceneObject):
    """Placement target with symmetric valid poses (reference target flavor)."""

    occupied: bool = False
    place_config: List[Dict[str, Any]] = field(default_factory=list)
    rotational_symmetries: int = 4

    def get_valid_poses(self) -> List[Affine]:
        poses = []
        for k in range(self.rotational_symmetries):
            angle = 2 * np.pi * k / self.rotational_symmetries
            poses.append(self.pose * Affine(rotation=[0, 0, angle]))
        return poses

    def compute_pose_errors(self, object_pose: Affine) -> List[Tuple[float, float]]:
        from ...transform_utils.differences import transformation_difference
        return [transformation_difference(p, object_pose)
                for p in self.get_valid_poses()]


def register() -> None:
    factory.register_object("scene_object", SceneObject)
    factory.register_object("pick_object", PickObject)
    factory.register_object("target_object", TargetObject)
    factory.register_object("sphere_object", SphereObject)


@dataclass
class SphereObject(SceneObject):
    """Procedural sphere pickable from the top — used by the virtual-scene data
    collection pipeline (no URDF assets required)."""

    static: bool = False
    radius: float = 0.04
    color: tuple = (0.8, 0.3, 0.3)

    def __post_init__(self):
        if self.min_dist == 0.0:
            self.min_dist = self.radius

    def get_valid_poses(self) -> List[Affine]:
        # top-down grasp at the sphere apex, gripper z pointing down
        flip = Affine(rotation=np.diag([1.0, -1.0, -1.0]))
        return [Affine(translation=[0, 0, self.radius]) * flip]

    def compute_pose_errors(self, gripper_pose: Affine,
                            rotational_symmetries: int = 1) -> List[Tuple[float, float]]:
        valid = self.pose * self.get_valid_poses()[0]
        t_error = float(np.linalg.norm(valid.translation
                                       - gripper_pose.translation))
        # spheres are grasp-rotation invariant about z; error = z-axis tilt
        cos = float(np.clip(np.dot(valid.rotation[:, 2],
                                   gripper_pose.rotation[:, 2]), -1, 1))
        return [(t_error, float(np.arccos(cos)))]
