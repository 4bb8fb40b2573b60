"""Task-framework protocols: Task, TaskFactory, Oracle, Scene, Robot,
SceneObject, Primitive, Sensor (tcnerf/tasks/protocols.py).

Structural-typing equivalents of the reference's protocol modules
(manipulation_tasks/{task,oracle,scene,object,primitive,sensor}.py). Kept in a
single module; thin re-export shims (`tasks.task`, `.oracle`, ...) preserve
the reference's import layout.
"""

from __future__ import annotations

from typing import Any, Dict, List, Protocol, Tuple, runtime_checkable

import numpy as np

from .dataclasses import Action, Objective
from .transform import Affine


@runtime_checkable
class Primitive(Protocol):
    def execute(self, action: Action, scene: "Scene") -> None: ...


@runtime_checkable
class Sensor(Protocol):
    pose: Affine

    def get_observation(self) -> Dict[str, np.ndarray]: ...

    def get_config(self) -> Dict[str, Any]: ...


@runtime_checkable
class Robot(Protocol):
    def home(self) -> bool: ...

    def ptp(self, pose: Affine) -> bool: ...

    def lin(self, pose: Affine) -> bool: ...

    def open_gripper(self, **kwargs) -> bool: ...

    def close_gripper(self, **kwargs) -> bool: ...


class Scene(Protocol):
    robot: Robot
    sensors: Dict[str, Dict[str, Any]]
    t_bounds: np.ndarray
    r_bounds: np.ndarray

    def get_observation(self, sensor_name: str,
                        poses: List[Affine] = None) -> List[Dict[str, np.ndarray]]: ...

    def spawn_coordinate_frame(self, pose: Affine) -> None: ...

    def clean(self) -> None: ...


class SimulatedScene(Scene, Protocol):
    def add_object(self, o: "SceneObject") -> int: ...

    def remove_objects(self, object_ids: List[int]) -> None: ...

    def shutdown(self) -> None: ...

    def get_object_pose(self, object_id: int) -> Affine: ...


class SceneObject(Protocol):
    urdf_path: str
    object_id: int
    static: bool
    pose: Affine
    min_dist: float
    offset: Affine
    unique_id: int


class ManipulationObject(SceneObject, Protocol):
    def get_valid_poses(self) -> List[Affine]: ...

    def compute_pose_errors(self, gripper_pose: Affine,
                            rotational_symmetries: int) -> List[Tuple[float, float]]: ...


class TargetObject(SceneObject, Protocol):
    occupied: bool

    def get_valid_poses(self) -> List[Affine]: ...

    def compute_pose_errors(self, object_pose: Affine) -> List[Tuple[float, float]]: ...


class Task(Protocol):
    primitive: Primitive
    objectives: List[Objective]
    manipulation_objects: List[ManipulationObject]
    target_objects: List[TargetObject]

    def get_info(self) -> Dict[str, Any]: ...

    def execute(self, action: Action, scene: Scene) -> None: ...

    def get_object_with_unique_id(self, unique_id: int) -> SceneObject: ...

    def setup(self, scene: SimulatedScene) -> None: ...

    def clean(self, scene: SimulatedScene) -> None: ...


class TaskFactory(Protocol):
    def create_task(self) -> Task: ...


class Oracle(Protocol):
    def execute(self, action: Action, task: Task, scene: Scene = None) -> None: ...

    def solve(self, task: Task) -> Tuple[Action, bool]: ...

    def compute_attention_errors(self, task: Task,
                                 attention_pose: Affine) -> List[Tuple[float, float]]: ...

    def compute_transport_errors(self, task: Task, attention_pose: Affine,
                                 transport_pose: Affine) -> List[Tuple[float, float]]: ...

    def compute_simulated_error(self, task: Task, attention_pose: Affine,
                                scene: Scene) -> List[Tuple[float, float]]: ...


def is_overlapping(pose: Affine, min_dist: float, objects) -> bool:
    """Planar overlap test for object placement (reference object.py:87-93)."""
    for o in objects:
        if np.linalg.norm(pose.translation[:2] - o.pose.translation[:2]) < (
                min_dist + o.min_dist):
            return True
    return False
