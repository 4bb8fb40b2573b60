"""Camera helpers (host-side numpy): the port's own copies of
tcnerf/data/generators.py `camera_parameters` and tcnerf/data/synthetic.py
`look_at_pose` / `camera_ring`."""

from __future__ import annotations

from typing import Optional

import numpy as np


def camera_parameters(camera_config):
    """{'pose', 'intrinsics' (9-flat)} -> (inverse extrinsics, padded 4x4 K)."""
    intr = np.reshape(camera_config["intrinsics"], (3, 3))
    k4 = np.eye(4)
    k4[:3, :3] = intr
    ext_inv = np.linalg.inv(camera_config["pose"])
    return ext_inv, k4


def look_at_pose(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world pose whose +z looks at `target`."""
    position = np.asarray(position, np.float64)
    target = np.asarray(target, np.float64)
    z_axis = target - position
    z_axis /= np.linalg.norm(z_axis)
    x_axis = np.cross(z_axis, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(x_axis) < 1e-8:
        x_axis = np.array([1.0, 0.0, 0.0])
    else:
        x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    y_axis /= np.linalg.norm(y_axis)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([x_axis, y_axis, z_axis], axis=1)
    pose[:3, 3] = position
    return pose


def camera_ring(n_perspectives: int, center=(0.5, 0.0, 0.0), radius: float = 0.9,
                polar: float = 0.7, height: int = 480, width: int = 640,
                focal: Optional[float] = None, azimuth_span: float = 2 * np.pi):
    """N camera configs {'pose': 4x4, 'intrinsics': 9-flat} on a ring (or an
    arc when `azimuth_span` < 2*pi) looking at `center`."""
    if focal is None:
        focal = 0.9 * width
    center = np.asarray(center, np.float64)
    intr = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
                    dtype=np.float64)
    full_ring = abs(azimuth_span - 2 * np.pi) < 1e-9 or n_perspectives < 2
    denom = n_perspectives if full_ring else (n_perspectives - 1)
    configs = []
    for i in range(n_perspectives):
        azimuth = azimuth_span * i / denom
        pos = center + radius * np.array(
            [np.sin(polar) * np.cos(azimuth), np.sin(polar) * np.sin(azimuth),
             np.cos(polar)])
        configs.append({"pose": look_at_pose(pos, center),
                        "intrinsics": intr.reshape(-1).copy()})
    return configs
