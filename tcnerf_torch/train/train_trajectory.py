"""Trajectory grasp-field training (tcnerf/train/train_trajectory.py): the
delta-NGF trainer on `trajectory_1_view-2` with alternating t / r
validation ascent (sync off).

    python -m tcnerf_torch.train.train_trajectory [--config-name=<name>] [key=value ...]
"""

from __future__ import annotations

from typing import List, Optional

from .grasp_common import GraspRun, entry
from .train_delta_ngf import run_delta_training


def run_trajectory_training(cfg, device=None) -> GraspRun:
    return run_delta_training(cfg, sync=False,
                              wandb_project="nerf-manipulation",
                              device=device)


def main(argv: Optional[List[str]] = None):
    return entry(argv, "trajectory_1_view-2", run_trajectory_training)


if __name__ == "__main__":
    main()
