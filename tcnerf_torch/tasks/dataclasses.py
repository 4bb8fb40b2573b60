"""Objective and Action dataclasses (tcnerf/tasks/dataclasses.py, after
the reference's manipulation_tasks/dataclasses.py:6-40)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .transform import Affine


@dataclass
class Objective:
    """Transport a manipulation object to one of its valid target poses."""

    completed: bool = False
    object_unique_id: int = -1
    target_unique_ids: List[int] = None


@dataclass
class Action:
    """A sequence of gripper poses consumed by a Primitive."""

    poses: List[Affine]
    type: str = None

    def __getitem__(self, i):
        return self.poses[i]

    def __len__(self):
        return len(self.poses)

    def __iter__(self):
        return iter(self.poses)
