"""Pick / Place / PickAndPlace motion primitives
(tcnerf/tasks/plugins/primitives/pick_and_place.py, after the reference's
plugins/primitives/pick_and_place.py:8-67)."""

from __future__ import annotations

from typing import Optional

from ... import factory
from ...dataclasses import Action
from ...transform import Affine


class Pick:
    def __init__(self, pre_grasp_offset: Affine = None,
                 post_grasp_offset: Optional[Affine] = None):
        self.pre_grasp_offset = pre_grasp_offset or Affine(translation=[0, 0, 0.075])
        self.post_grasp_offset = post_grasp_offset or self.pre_grasp_offset

    def execute(self, action: Action, scene) -> None:
        scene.robot.ptp(self.pre_grasp_offset * action[0])
        scene.robot.open_gripper()
        scene.robot.lin(action[0])
        scene.robot.close_gripper()
        scene.robot.lin(self.post_grasp_offset * action[0])


class Place:
    def __init__(self, pre_place_offset: Affine = None,
                 post_place_offset: Optional[Affine] = None):
        self.pre_place_offset = pre_place_offset or Affine(translation=[0, 0, 0.075])
        self.post_place_offset = post_place_offset or self.pre_place_offset

    def execute(self, action: Action, scene) -> None:
        scene.robot.ptp(self.pre_place_offset * action[0])
        scene.robot.lin(action[0])
        scene.robot.open_gripper()
        scene.robot.lin(self.post_place_offset * action[0])


class PickAndPlace:
    def __init__(self, pick: Pick = None, place: Place = None):
        self.pick = pick or Pick()
        self.place = place or Place()

    def execute(self, action: Action, scene) -> None:
        self.pick.execute(Action([action[0]]), scene)
        self.place.execute(Action([action[1]]), scene)


def register() -> None:
    factory.register_primitive("pick-primitive", Pick)
    factory.register_primitive("place-primitive", Place)
    factory.register_primitive("pick-and-place-primitive", PickAndPlace)
