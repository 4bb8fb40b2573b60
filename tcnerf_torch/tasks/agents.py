"""The oracle's pose error for validation (tcnerf/tasks/agents.py
`OracleAgent.calculate_error`). The task plugins and `setup_oracle` are not
ported: validation uses this oracle."""

from __future__ import annotations

import numpy as np


class OracleAgent:
    def calculate_error(self, gt_pose, pose):
        """Poses [(tx, ty, tz), (qx, qy, qz, qw)] -> (translational error
        in metres, rotational error in radians)."""
        t_gt = np.asarray(gt_pose[0], dtype=np.float64)
        t = np.asarray(pose[0], dtype=np.float64)
        q_gt = np.asarray(gt_pose[1], dtype=np.float64)
        q = np.asarray(pose[1], dtype=np.float64)
        q_gt = q_gt / np.linalg.norm(q_gt)
        q = q / np.linalg.norm(q)
        translational = float(np.linalg.norm(t_gt - t))
        dot = np.clip(np.abs(np.dot(q_gt, q)), 0.0, 1.0)
        rotational = float(2.0 * np.arccos(dot))
        return translational, rotational
