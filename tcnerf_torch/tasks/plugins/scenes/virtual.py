"""Virtual kinematic scene: no physics, analytic ray-traced cameras
(tcnerf/tasks/plugins/scenes/virtual.py).

The reference's PyBullet scenes live in submodules that are not shipped
(SURVEY.md §2.9/§2.10); this plugin provides a complete SimulatedScene
implementation over this package's `data.synthetic` (`SyntheticScene`,
`camera_ring`) so tasks can be set up, observed from posed cameras, and
"executed" (kinematically) — enough to collect posed RGB datasets + grasp
labels end-to-end.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ...transform import Affine
from ... import factory


class LoggingRobot:
    """Records motion commands instead of executing them."""

    def __init__(self):
        self.commands: List = []
        self.gripper_open = True

    def home(self) -> bool:
        self.commands.append(("home",))
        return True

    def ptp(self, pose: Affine) -> bool:
        self.commands.append(("ptp", pose))
        return True

    def lin(self, pose: Affine) -> bool:
        self.commands.append(("lin", pose))
        return True

    def open_gripper(self, **kwargs) -> bool:
        self.commands.append(("open_gripper",))
        self.gripper_open = True
        return True

    def close_gripper(self, **kwargs) -> bool:
        self.commands.append(("close_gripper",))
        self.gripper_open = False
        return True


class VirtualScene:
    """SimulatedScene over the analytic sphere renderer.

    Objects added to the scene appear as spheres of radius `min_dist` (or an
    object-provided `radius`) at their poses; `get_observation` ray-traces the
    configured cameras.
    """

    def __init__(self, t_bounds=None, r_bounds=None,
                 sensors: Optional[Dict[str, Dict[str, Any]]] = None,
                 n_perspectives: int = 5, image_size=(480, 640), rng=None):
        from ....data.synthetic import camera_ring

        self.robot = LoggingRobot()
        self.t_bounds = np.asarray(
            t_bounds if t_bounds is not None
            else [[0.35, 0.85], [-0.25, 0.25], [0.0, 0.2]])
        self.r_bounds = np.asarray(
            r_bounds if r_bounds is not None else [[0, 0], [0, 0], [0, 2 * np.pi]])
        self.image_size = tuple(image_size)
        self._rng = np.random.default_rng(rng)
        self._objects: Dict[int, Any] = {}
        self._next_id = 1
        self._frames: List[Affine] = []
        if sensors is None:
            configs = camera_ring(n_perspectives,
                                  center=self.t_bounds.mean(axis=1),
                                  height=self.image_size[0],
                                  width=self.image_size[1])
            sensors = {f"camera_{i}": cfg for i, cfg in enumerate(configs)}
        self.sensors = sensors

    # ------------------------------------------------------- SimulatedScene API

    def add_object(self, o) -> int:
        object_id = self._next_id
        self._next_id += 1
        self._objects[object_id] = o
        return object_id

    def remove_objects(self, object_ids: List[int]) -> None:
        for oid in object_ids:
            self._objects.pop(oid, None)

    def get_object_pose(self, object_id: int) -> Affine:
        return self._objects[object_id].pose

    def shutdown(self) -> None:
        self._objects.clear()

    # ----------------------------------------------------------------- Scene API

    def _as_scene(self):
        from ....data.synthetic import SyntheticScene

        centers, radii, colors = [], [], []
        for o in self._objects.values():
            radius = getattr(o, "radius", None) or max(
                float(getattr(o, "min_dist", 0.03)), 0.01)
            centers.append(np.asarray(o.pose.translation, np.float64))
            radii.append(radius)
            colors.append(getattr(o, "color", (0.8, 0.3, 0.3)))
        if not centers:
            centers = np.zeros((0, 3))
            radii = np.zeros((0,))
            colors = np.zeros((0, 3))
        return SyntheticScene(centers=np.asarray(centers),
                              radii=np.asarray(radii),
                              colors=np.asarray(colors))

    def get_observation(self, sensor_name: str,
                        poses: List[Affine] = None) -> List[Dict[str, np.ndarray]]:
        scene = self._as_scene()
        observations = []
        sensor_names = ([sensor_name] if sensor_name in self.sensors
                        else list(self.sensors))
        for name in sensor_names:
            cfg = self.sensors[name]
            color = scene.render(np.asarray(cfg["pose"]),
                                 np.reshape(cfg["intrinsics"], (3, 3)),
                                 self.image_size[0], self.image_size[1])
            observations.append({"color": color,
                                 "pose": np.asarray(cfg["pose"]),
                                 "intrinsics": np.asarray(cfg["intrinsics"])})
        return observations

    def spawn_coordinate_frame(self, pose: Affine) -> None:
        self._frames.append(pose)

    def clean(self) -> None:
        self._frames.clear()


def register() -> None:
    factory.register_simulated_scene("virtual-scene", VirtualScene)
