"""Suction-grasp oracle: solve, execute, and error computation
(tcnerf/tasks/plugins/oracles/suction_grasp.py, after the reference's
plugins/oracles/suction_grasp.py:11-112); registered as
'suction_grasp-oracle' with a gripper offset from config
(src/alt_configs/validation/oracle/grasp.yaml)."""

from __future__ import annotations

import numpy as np

from ...dataclasses import Action, Objective
from ...transform import Affine
from ... import factory


class SuctionGraspOracle:
    attention_symmetries: int = 2

    def __init__(self, gripper_offset, rng=None):
        self.gripper_offset = Affine(**gripper_offset)
        self.rng = np.random.default_rng(rng)
        self.selected_objective: Objective = None
        self.selected_object = None
        self.solution_executable = False

    def execute(self, action: Action, task, scene=None):
        if not self.solution_executable:
            raise RuntimeError("solution not executable")
        self.selected_objective.completed = True
        if scene is not None:
            task.execute(action, scene)
            scene.remove_objects([self.selected_object.object_id])
        else:
            task.grasped_objects.append(self.selected_object)
        task.manipulation_objects.remove(self.selected_object)
        self.solution_executable = False

    def solve(self, task):
        unsolved = [o for o in task.objectives if not o.completed]
        self.selected_objective = unsolved[int(self.rng.integers(len(unsolved)))]
        self.selected_object = task.get_object_with_unique_id(
            self.selected_objective.object_unique_id)
        relative = self.selected_object.get_valid_poses()[0] * self.gripper_offset
        pick_pose = self.selected_object.pose * relative
        self.solution_executable = True
        return Action([pick_pose]), len(unsolved) - 1 <= 0

    def compute_attention_errors(self, task, attention_pose: Affine):
        unsolved = [o for o in task.objectives if not o.completed]
        real_pose = attention_pose * self.gripper_offset.invert()
        errors = []
        for objective in unsolved:
            obj = task.get_object_with_unique_id(objective.object_unique_id)
            errors += obj.compute_pose_errors(real_pose, self.attention_symmetries)
        return sorted(errors, key=lambda tup: tup[0])

    def compute_transport_errors(self, task, attention_pose: Affine,
                                 transport_pose: Affine):
        unsolved = [o for o in task.objectives if not o.completed]
        real_transport = transport_pose * self.gripper_offset.invert()
        real_attention = attention_pose * self.gripper_offset.invert()
        errors = []
        for objective in unsolved:
            obj = task.get_object_with_unique_id(objective.object_unique_id)
            relative_attention = real_attention / obj.pose
            targets = [task.get_object_with_unique_id(tid)
                       for tid in (objective.target_unique_ids or [])]
            for target in (t for t in targets if not t.occupied):
                object_pose = real_transport * relative_attention.invert()
                errors += target.compute_pose_errors(object_pose)
        return sorted(errors, key=lambda tup: tup[0])

    def compute_simulated_error(self, task, attention_pose: Affine, scene):
        def distance(objective):
            obj = task.get_object_with_unique_id(objective.object_unique_id)
            return np.linalg.norm(attention_pose.translation - obj.pose.translation)

        sorted_objectives = sorted(task.objectives, key=distance)
        selected = task.get_object_with_unique_id(
            sorted_objectives[0].object_unique_id)
        new_pose = scene.get_object_pose(selected.object_id)
        errors = []
        for target_id in (sorted_objectives[0].target_unique_ids or []):
            target = task.get_object_with_unique_id(target_id)
            errors += target.compute_pose_errors(new_pose)
        return errors


def register() -> None:
    factory.register_oracle("suction_grasp-oracle", SuctionGraspOracle)
