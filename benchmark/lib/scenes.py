"""Cameras and inputs made from the seed.

`look_at_pose` and `camera_ring` are copied from
`tcnerf_torch/data/synthetic.py` and frozen here; `grasp_cameras` follows
`chip_smoke.py` `grasp_scene`. Every draw comes from a numpy stream keyed
by (seed, purpose, index), so one seed gives the same inputs in every run
and the program and the reference get the same ones.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

PURPOSES = {"scene": 1, "guesses": 2, "view": 3, "sample": 4,
            "dataset": 5, "draws": 6, "batches": 7}


def stream(seed: int, purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, PURPOSES[purpose],
                                  int(index)])


def derived_seed(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for a torch generator or a program's own rng."""
    return int(stream(seed, purpose, index).integers(0, 2 ** 62))


def look_at_pose(position, target) -> np.ndarray:
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


def camera_ring(n: int, center=(0.5, 0.0, 0.0), radius: float = 0.9,
                polar: float = 0.7, height: int = 480, width: int = 640,
                focal: Optional[float] = None, azimuth0: float = 0.0
                ) -> List[dict]:
    """n camera configs {'pose': 4x4, 'intrinsics': 9-flat} evenly on a
    ring looking at `center`, starting at azimuth `azimuth0`."""
    focal = 0.9 * width if focal is None else focal
    center = np.asarray(center, np.float64)
    intr = np.array([[focal, 0, width / 2], [0, focal, height / 2],
                     [0, 0, 1]], dtype=np.float64)
    out = []
    for i in range(n):
        az = azimuth0 + 2 * np.pi * i / n
        pos = center + radius * np.array([np.sin(polar) * np.cos(az),
                                          np.sin(polar) * np.sin(az),
                                          np.cos(polar)])
        out.append({"pose": look_at_pose(pos, center),
                    "intrinsics": intr.reshape(-1).copy()})
    return out


def grasp_cameras(n_images: int, height: int, width: int):
    """(intrinsics [1, n, 4, 4], inverse extrinsics [1, n, 4, 4]) float32
    of a camera ring of n views around the workspace's centre."""
    cfgs = camera_ring(n_images, height=height, width=width)
    k4 = np.tile(np.eye(4, dtype=np.float32), (n_images, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in cfgs]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in cfgs], np.float32)
    return k4[None], ext[None]


def grasp_images(seed: int, i: int, n_images: int, height: int, width: int
                 ) -> np.ndarray:
    """Request i's images [1, n, H, W, 3] float32 in [0, 1)."""
    return stream(seed, "scene", i).random((1, n_images, height, width, 3),
                                           dtype=np.float32)


def view_request(seed: int, i: int, height: int, width: int):
    """Request i of the view traffic: a uint8 source image [H, W, 3], its
    camera and the target camera, both on a ring of 8 positions turned by
    a seeded azimuth, the target 1-3 positions from the source."""
    rng = stream(seed, "view", i)
    image = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    ring = camera_ring(8, height=height, width=width,
                       azimuth0=float(rng.uniform(0, 2 * np.pi)))
    src = int(rng.integers(0, 8))
    tgt = (src + int(rng.integers(1, 4))) % 8
    return image, ring[src], ring[tgt]


def write_nerf_dataset(root: str, seed: int, n_scenes: int,
                       n_perspectives: int, height: int, width: int) -> None:
    """A stage-1 training set in the layout `tcnerf_torch/data/loaders.py`
    reads: per scene `color/sample_<i>.npz` ('colors' [P, H, W, 4] uint8,
    seeded noise, alpha 255) and `camera_config/sample_<i>.pkl` (a ring of
    P cameras turned by a seeded azimuth)."""
    for d in ("color", "camera_config"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n_scenes):
        rng = stream(seed, "dataset", i)
        colors = rng.integers(0, 256, (n_perspectives, height, width, 4),
                              dtype=np.uint8)
        colors[..., 3] = 255
        cams = camera_ring(n_perspectives, height=height, width=width,
                           azimuth0=float(rng.uniform(0, 2 * np.pi)))
        np.savez(os.path.join(root, "color", f"sample_{i:08d}.npz"),
                 colors=colors)
        with open(os.path.join(root, "camera_config",
                               f"sample_{i:08d}.pkl"), "wb") as f:
            pickle.dump(cams, f)
