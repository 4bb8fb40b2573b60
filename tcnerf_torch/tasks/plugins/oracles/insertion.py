"""Insertion oracle: pick-and-place into unoccupied targets
(tcnerf/tasks/plugins/oracles/insertion.py, after the reference's
plugins/oracles/insertion.py)."""

from __future__ import annotations

import numpy as np

from ...dataclasses import Action, Objective
from ...transform import Affine
from ... import factory


class InsertionOracle:
    attention_symmetries: int = 2

    def __init__(self, gripper_offset, rng=None):
        self.gripper_offset = Affine(**gripper_offset)
        self.rng = np.random.default_rng(rng)
        self.selected_objective: Objective = None
        self.selected_object = None
        self.selected_target = None
        self.new_object_pose: Affine = None
        self.solution_executable = False

    def execute(self, action: Action, task, scene=None):
        if not self.solution_executable:
            raise RuntimeError("solution not executable")
        self.selected_object.pose = self.new_object_pose
        self.selected_target.occupied = True
        self.selected_objective.completed = True
        if scene is not None:
            task.execute(action, scene)
        self.solution_executable = False

    def solve(self, task):
        unsolved = [o for o in task.objectives if not o.completed]
        self.selected_objective = unsolved[int(self.rng.integers(len(unsolved)))]
        self.selected_object = task.get_object_with_unique_id(
            self.selected_objective.object_unique_id)
        targets = [task.get_object_with_unique_id(tid)
                   for tid in self.selected_objective.target_unique_ids]
        available = [t for t in targets if not t.occupied]
        self.selected_target = available[int(self.rng.integers(len(available)))]

        relative_pick = (self.selected_object.get_valid_poses()[0]
                         * self.gripper_offset)
        relative_place = self.selected_target.get_valid_poses()[0]
        self.new_object_pose = self.selected_target.pose * relative_place

        pick_pose = self.selected_object.pose * relative_pick
        place_pose = self.new_object_pose * relative_pick
        self.solution_executable = True
        return Action([pick_pose, place_pose]), len(unsolved) - 1 <= 0

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
            return np.linalg.norm(attention_pose.translation
                                  - obj.pose.translation)

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
    factory.register_oracle("insertion-oracle", InsertionOracle)
