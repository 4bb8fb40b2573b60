"""Re-export shim preserving the reference's manipulation_tasks.scene import
layout (tcnerf/tasks/scene.py)."""

from .protocols import *  # noqa: F401,F403
from .dataclasses import Action, Objective  # noqa: F401
