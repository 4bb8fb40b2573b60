"""Re-export shim preserving the reference's manipulation_tasks.sensor import
layout (tcnerf/tasks/sensor.py)."""

from .protocols import *  # noqa: F401,F403
from .dataclasses import Action, Objective  # noqa: F401
