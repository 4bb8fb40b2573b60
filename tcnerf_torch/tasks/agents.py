"""The oracle's pose error for validation and the plugin oracle's
construction (tcnerf/tasks/agents.py): `OracleAgent.calculate_error`, which
validation falls back to for an oracle without one (the task plugins'
oracles, such as the suction oracle, have none), and `setup_oracle`."""

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


def setup_oracle(plugins_cfg=None, oracle_cfg=None):
    """Plugin-based oracle construction (reference flat `setup_oracle`,
    src/train_goal.py:90): load the task plugins (a list of names, or a
    dict with a "plugins" list), then create the configured oracle; without
    an oracle config, an `OracleAgent`."""
    from . import factory, loader

    if plugins_cfg:
        if isinstance(plugins_cfg, dict):
            plugins_cfg = plugins_cfg.get("plugins", [])
        loader.load_plugins(list(plugins_cfg))
    if oracle_cfg:
        cfg = {k: (v.to_dict() if hasattr(v, "to_dict") else v)
               for k, v in dict(oracle_cfg).items()}
        return factory.create_oracle(cfg)
    return OracleAgent()
