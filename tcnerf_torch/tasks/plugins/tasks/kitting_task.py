"""Kitting task: place 5 objects into fixed slots on a kitting board
(tcnerf/tasks/plugins/tasks/kitting_task.py, after the reference's
plugins/tasks/kitting_task.py)."""

from __future__ import annotations

from typing import List

import numpy as np

from ...dataclasses import Objective
from ...protocols import is_overlapping
from ...transform import Affine
from ... import factory


class Reset(Exception):
    pass


class KittingBoard:
    def __init__(self, pose: Affine, dimensions):
        self.pose = pose
        self.dimensions = np.asarray(dimensions, dtype=np.float64)
        self.min_dist = float(np.linalg.norm(self.dimensions[:2] / 2))
        self.unique_id = None
        self.object_id = -1
        self.offset = Affine()
        self.urdf_path = None
        self.static = True


class KittingTaskFactory:
    RELATIVE_TARGET_POSITIONS = [
        [-0.12, -0.0525, 0.007], [0, -0.0525, 0.007], [0.12, -0.0525, 0.007],
        [-0.06, 0.0525, 0.007], [0.06, 0.0525, 0.007],
    ]

    def __init__(self, t_bounds, r_bounds, object_types: List[str],
                 manipulation_type: str, primitive_type: str,
                 target_object_type: str = None, target_type: str = None,
                 kitting_board_urdf: str = None, rng=None):
        self.t_bounds = t_bounds
        self.r_bounds = r_bounds
        self.object_types = object_types
        self.n_objects = 5  # fixed slot count (reference :23)
        self.manipulation_type = manipulation_type
        self.primitive_type = primitive_type
        self.target_object_type = target_object_type
        self.target_type = target_type
        self.board_dimensions = np.array([0.37, 0.235, 0.014])
        self.rng = np.random.default_rng(rng)
        self.unique_id_counter = 0
        self.max_pose_tries = 2000
        self.max_create_tries = 10

    def get_unique_id(self) -> int:
        self.unique_id_counter += 1
        return self.unique_id_counter - 1

    def generate_kitting_board(self) -> KittingBoard:
        min_dist = float(np.linalg.norm(self.board_dimensions[:2] / 2))
        bounds = np.array(self.t_bounds, dtype=np.float64)
        bounds[:2, 0] += min_dist
        bounds[:2, 1] -= min_dist
        bounds[2, :] = self.board_dimensions[2] / 2
        return KittingBoard(
            Affine.random(t_bounds=bounds, r_bounds=self.r_bounds, rng=self.rng),
            self.board_dimensions)

    def generate_manipulation_object(self, object_type, added_objects):
        obj = factory.create_manipulation_object(object_type,
                                                 self.manipulation_type)
        bounds = np.array(self.t_bounds, dtype=np.float64)
        bounds[:2, 0] += obj.min_dist
        bounds[:2, 1] -= obj.min_dist
        for _ in range(self.max_pose_tries):
            pose = Affine.random(t_bounds=bounds, r_bounds=self.r_bounds,
                                 rng=self.rng)
            if not is_overlapping(pose, obj.min_dist, added_objects):
                obj.pose = obj.offset * pose
                obj.unique_id = self.get_unique_id()
                return obj
        raise Reset

    def generate_target_object(self, object_type, pos_idx, board_pose: Affine):
        target = factory.create_target_object(object_type,
                                              self.target_object_type,
                                              self.target_type)
        slot = Affine(translation=self.RELATIVE_TARGET_POSITIONS[pos_idx])
        target.pose = board_pose * slot
        target.unique_id = self.get_unique_id()
        return target

    def create_task(self):
        for _ in range(self.max_create_tries):
            self.unique_id_counter = 0
            chosen = [self.object_types[int(self.rng.integers(
                len(self.object_types)))] for _ in range(self.n_objects)]
            try:
                board = self.generate_kitting_board()
                objectives, manipulation_objects, target_objects = [], [], []
                pos_idx = 0
                for object_type in dict.fromkeys(chosen):
                    object_ids, target_ids = [], []
                    for _ in range(chosen.count(object_type)):
                        obj = self.generate_manipulation_object(
                            object_type, manipulation_objects + [board])
                        manipulation_objects.append(obj)
                        object_ids.append(obj.unique_id)
                        target = self.generate_target_object(
                            object_type, pos_idx, board.pose)
                        pos_idx += 1
                        target_objects.append(target)
                        target_ids.append(target.unique_id)
                    for oid in object_ids:
                        objectives.append(Objective(
                            completed=False, object_unique_id=oid,
                            target_unique_ids=target_ids))
                return KittingTask(objectives, manipulation_objects,
                                   target_objects, board, self.primitive_type)
            except Reset:
                continue
        raise RuntimeError("could not place kitting task objects")


class KittingTask:
    def __init__(self, objectives, manipulation_objects, target_objects,
                 kitting_board: KittingBoard, primitive_type: str):
        self.primitive_type = primitive_type
        self.primitive = factory.create_primitive(
            {"primitive_type": primitive_type})
        self.objectives = objectives
        self.manipulation_objects = manipulation_objects
        self.target_objects = target_objects
        self.kitting_board = kitting_board

    def get_info(self):
        return {
            "objectives": self.objectives,
            "manipulation_objects": self.manipulation_objects,
            "target_objects": self.target_objects,
            "primitive_type": self.primitive_type,
            "task_type": "kitting-task",
        }

    def execute(self, action, scene):
        self.primitive.execute(action, scene)

    def get_object_with_unique_id(self, unique_id: int):
        for o in self.manipulation_objects + self.target_objects:
            if o.unique_id == unique_id:
                return o
        raise RuntimeError("object id mismatch")

    def setup(self, scene):
        scene.robot.home()
        self.kitting_board.object_id = scene.add_object(self.kitting_board)
        for o in self.manipulation_objects:
            o.object_id = scene.add_object(o)
        for o in self.target_objects:
            if o.urdf_path is not None:
                o.object_id = scene.add_object(o)

    def clean(self, scene):
        scene.remove_objects(
            [self.kitting_board.object_id]
            + [o.object_id for o in self.manipulation_objects])


def register() -> None:
    factory.register_task_factory("kitting-task-factory", KittingTaskFactory)
    factory.register_task("kitting-task", KittingTask)
