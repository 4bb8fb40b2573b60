"""Learning-rate schedules (tcnerf/opt/schedules.py): functions of the
update count that return the learning rate, computed in float32 as the
JAX schedules are."""

from __future__ import annotations

from typing import Callable

import numpy as np


def warmup_constant_schedule(target_lr: float, warmup_steps: int,
                             scale_down_after: int = 400000
                             ) -> Callable[[int], float]:
    """Linear warmup -> constant -> x0.1 after `scale_down_after` steps."""
    warmup = np.float32(max(1.0, float(warmup_steps)))
    lr = np.float32(target_lr)

    def schedule(step: int) -> float:
        step = np.float32(step)
        if step <= warmup:
            return float(step / warmup * lr)
        return float(lr if step <= scale_down_after
                     else np.float32(0.1 * target_lr))

    return schedule


def exponential_decay(init_lr: float, decay_rate: float,
                      decay_steps: int = 1) -> Callable[[int], float]:
    """Continuous exponential decay: lr = init * rate^(step / decay_steps)."""

    def schedule(step: int) -> float:
        step = np.float32(step)
        return float(np.float32(init_lr) * np.power(
            np.float32(decay_rate), step / np.float32(decay_steps)))

    return schedule
