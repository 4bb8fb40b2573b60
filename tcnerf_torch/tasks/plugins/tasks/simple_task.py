"""Pick-and-place task with manipulation + target objects
(tcnerf/tasks/plugins/tasks/simple_task.py, after the reference's
plugins/tasks/simple_task.py)."""

from __future__ import annotations

from typing import List

import numpy as np

from ...dataclasses import Objective
from ...protocols import is_overlapping
from ...transform import Affine
from ... import factory


class SimpleTaskFactory:
    def __init__(self, t_bounds, r_bounds, object_types: List[str], n_objects: int,
                 manipulation_type: str, primitive_type: str,
                 target_object_type: str = None, target_type: str = None,
                 rng=None):
        self.t_bounds = t_bounds
        self.r_bounds = r_bounds
        self.object_types = object_types
        self.n_objects = n_objects
        self.manipulation_type = manipulation_type
        self.primitive_type = primitive_type
        self.target_object_type = target_object_type
        self.target_type = target_type
        self.rng = np.random.default_rng(rng)
        self.unique_id_counter = 0

    def get_unique_id(self) -> int:
        self.unique_id_counter += 1
        return self.unique_id_counter - 1

    def create_task(self):
        self.unique_id_counter = 0
        chosen = [self.object_types[int(self.rng.integers(len(self.object_types)))]
                  for _ in range(self.n_objects)]
        objectives, manipulation_objects, target_objects = [], [], []
        for object_type in dict.fromkeys(chosen):
            object_ids, target_ids = [], []
            for _ in range(chosen.count(object_type)):
                obj = self._place(
                    factory.create_manipulation_object(object_type,
                                                       self.manipulation_type),
                    manipulation_objects + target_objects)
                manipulation_objects.append(obj)
                object_ids.append(obj.unique_id)
                target = self._place(
                    factory.create_target_object(object_type,
                                                 self.target_object_type,
                                                 self.target_type),
                    manipulation_objects + target_objects)
                target_objects.append(target)
                target_ids.append(target.unique_id)
            for oid in object_ids:
                objectives.append(Objective(completed=False, object_unique_id=oid,
                                            target_unique_ids=target_ids))
        return SimpleTask(objectives, manipulation_objects, target_objects,
                          self.primitive_type)

    def _place(self, obj, added_objects):
        pose = self.get_non_overlapping_pose(obj.min_dist, added_objects)
        obj.pose = obj.offset * pose
        obj.unique_id = self.get_unique_id()
        return obj

    def get_non_overlapping_pose(self, min_dist, objects):
        t_bounds = np.array(self.t_bounds, dtype=np.float64)
        t_bounds[:2, 0] += min_dist
        t_bounds[:2, 1] -= min_dist
        while True:
            pose = Affine.random(t_bounds=t_bounds, r_bounds=self.r_bounds,
                                 rng=self.rng)
            if not is_overlapping(pose, min_dist, objects):
                return pose


class SimpleTask:
    def __init__(self, objectives, manipulation_objects, target_objects,
                 primitive_type: str):
        self.primitive_type = primitive_type
        self.primitive = factory.create_primitive(
            {"primitive_type": primitive_type})
        self.objectives = objectives
        self.manipulation_objects = manipulation_objects
        self.target_objects = target_objects

    def get_info(self):
        return {
            "objectives": self.objectives,
            "manipulation_objects": self.manipulation_objects,
            "target_objects": self.target_objects,
            "primitive_type": self.primitive_type,
            "task_type": "simple-task",
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
        for o in self.manipulation_objects:
            o.object_id = scene.add_object(o)
        for o in self.target_objects:
            if o.urdf_path is not None:
                o.object_id = scene.add_object(o)

    def clean(self, scene):
        scene.remove_objects(
            [o.object_id for o in self.manipulation_objects + self.target_objects])


def register() -> None:
    factory.register_task_factory("simple-task-factory", SimpleTaskFactory)
    factory.register_task("simple-task", SimpleTask)
