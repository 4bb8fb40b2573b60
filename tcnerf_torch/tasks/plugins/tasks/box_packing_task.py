"""Box-packing task: kd-partition a random box into blocks, scatter matching
pick blocks on the table, pack them back
(tcnerf/tasks/plugins/tasks/box_packing_task.py, after the reference's
plugins/tasks/box_packing_task.py).

The reference generates temp URDFs from templates for PyBullet; the
virtual scenes consume Block objects (pose + dimensions) directly, so no URDF
templating is needed — `setup(scene)` registers the same objects through
`scene.add_object`.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...dataclasses import Objective
from ...transform import Affine
from ... import factory


class Reset(Exception):
    pass


class Block:
    """A rigid cuboid with a pose, used both as pick object and target slot."""

    def __init__(self, pose: Affine, dimensions):
        self.pose = pose
        self.dimensions = np.asarray(dimensions, dtype=np.float64)
        self.unique_id = None
        self.object_id = -1
        self.min_dist = float(np.linalg.norm(self.dimensions[:2] / 2))
        self.offset = Affine()
        self.urdf_path = None
        self.static = False
        self.occupied = False

    def get_valid_poses(self):
        # rectangular blocks have a 2-fold placement symmetry about z
        return [Affine(), Affine(rotation=[0, 0, np.pi])]

    def compute_pose_errors(self, pose, rotational_symmetries: int = 2):
        from ...transform_utils.differences import transformation_difference
        errors = []
        for rel in self.get_valid_poses():
            errors.append(transformation_difference(self.pose * rel, pose))
        return sorted(errors, key=lambda t: t[0])


class BoxPackingTaskFactory:
    def __init__(self, t_bounds, r_bounds, manipulation_type: str = None,
                 primitive_type: str = "pick-and-place-primitive",
                 target_type: str = None, box_template_urdf: str = None,
                 block_template_path: str = None, rng=None):
        self.t_bounds = t_bounds
        self.r_bounds = r_bounds
        self.primitive_type = primitive_type
        self.rng = np.random.default_rng(rng)
        self.unique_id_counter = 0
        self.box_size_bounds = np.array([[0.05, 0.2], [0.05, 0.2]])
        self.max_pose_tries = 2000
        self.max_create_tries = 10
        self.min_object_dim = 0.04

    def get_unique_id(self) -> int:
        self.unique_id_counter += 1
        return self.unique_id_counter - 1

    def _kd_partition(self, block: Block, out: List[Block]):
        """Recursive random axis-aligned splits down to min_object_dim."""
        block.dimensions[2] = 0.05
        splittable = block.dimensions[:2] > 2 * self.min_object_dim
        if not splittable.any():
            out.append(block)
            return
        axis = int(self.rng.choice(np.where(splittable)[0]))
        cut = (self.rng.random() * (block.dimensions[axis]
                                    - 2 * self.min_object_dim)
               + self.min_object_dim)

        for child_dim_axis, shift_sign in ((cut, -1),
                                           (block.dimensions[axis] - cut, +1)):
            dims = block.dimensions.copy()
            dims[axis] = child_dim_axis
            pos = block.pose.translation.copy()
            pos[axis] += shift_sign * (block.dimensions[axis] - child_dim_axis) / 2
            child = Block(Affine(translation=pos, rotation=block.pose.rotation),
                          dims)
            self._kd_partition(child, out)

    def _bounds_for(self, dims):
        min_dist = float(np.linalg.norm(np.asarray(dims[:2]) / 2))
        b = np.array(self.t_bounds, dtype=np.float64)
        b[:2, 0] += min_dist
        b[:2, 1] -= min_dist
        b[2, :] = dims[2] / 2
        return b, min_dist

    def generate_box(self) -> Block:
        width = self.rng.uniform(*self.box_size_bounds[0])
        length = self.rng.uniform(*self.box_size_bounds[1])
        dims = np.array([width, length, 0.002])
        bounds, _ = self._bounds_for(dims)
        return Block(Affine.random(t_bounds=bounds, r_bounds=self.r_bounds,
                                   rng=self.rng), dims)

    def _non_overlapping_block(self, dims, objects) -> Block:
        bounds, min_dist = self._bounds_for(dims)
        for _ in range(self.max_pose_tries):
            pose = Affine.random(t_bounds=bounds, r_bounds=self.r_bounds,
                                 rng=self.rng)
            if not any(np.linalg.norm(pose.translation[:2]
                                      - o.pose.translation[:2])
                       < min_dist + o.min_dist for o in objects):
                return Block(pose, dims)
        raise Reset

    def create_task(self):
        for _ in range(self.max_create_tries):
            self.unique_id_counter = 0
            try:
                box = self.generate_box()
                targets: List[Block] = []
                self._kd_partition(Block(box.pose, box.dimensions.copy()),
                                   targets)
                picks, objectives = [], []
                for t in targets:
                    t.unique_id = self.get_unique_id()
                    new_block = self._non_overlapping_block(
                        t.dimensions, picks + [box])
                    new_block.unique_id = self.get_unique_id()
                    picks.append(new_block)
                    objectives.append(Objective(
                        object_unique_id=new_block.unique_id,
                        target_unique_ids=[t.unique_id]))
                return BoxPackingTask(objectives, picks, targets, box,
                                      self.primitive_type)
            except Reset:
                continue
        raise RuntimeError(
            "Objects always overlap. Try to reduce number of objects in task.")


class BoxPackingTask:
    def __init__(self, objectives, manipulation_blocks, target_blocks,
                 box_block: Block, primitive_type: str):
        self.primitive_type = primitive_type
        self.primitive = factory.create_primitive(
            {"primitive_type": primitive_type})
        self.objectives = objectives
        self.manipulation_objects = manipulation_blocks
        self.target_objects = target_blocks
        self.box_block = box_block

    def get_info(self):
        return {
            "objectives": self.objectives,
            "manipulation_objects": self.manipulation_objects,
            "target_objects": self.target_objects,
            "primitive_type": self.primitive_type,
            "task_type": "box-packing-task",
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
        for o in [self.box_block] + self.manipulation_objects:
            o.object_id = scene.add_object(o)

    def clean(self, scene):
        scene.remove_objects(
            [o.object_id for o in [self.box_block] + self.manipulation_objects])


def register() -> None:
    factory.register_task_factory("box-packing-task-factory",
                                  BoxPackingTaskFactory)
    factory.register_task("box-packing-task", BoxPackingTask)
