"""Synthetic tabletop scenes and camera rings (tcnerf/data/synthetic.py):
coloured spheres on a checkered ground plane, ray-traced exactly with
Lambertian shading (host-side numpy), rendered from a ring of cameras in the
`{'pose': 4x4, 'intrinsics': 9-flat}` format the data layer reads, with a
top-down grasp pose above a target sphere, its approach trajectory, a
language instruction naming the sphere's colour and the scene's info. The
same seed writes the same files as the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..core.rays import get_rays_np
from .dataset import ColorDataset, NPZDataset, PickleDataset


@dataclass
class SyntheticScene:
    centers: np.ndarray  # [N, 3]
    radii: np.ndarray    # [N]
    colors: np.ndarray   # [N, 3] in [0, 1]
    plane_colors: Tuple[Tuple[float, float, float],
                        Tuple[float, float, float]] = (
        (0.65, 0.65, 0.65), (0.35, 0.35, 0.38))
    background: Tuple[float, float, float] = (0.05, 0.05, 0.08)
    light_dir: np.ndarray = field(
        default_factory=lambda: np.array([0.3, -0.5, -0.8]))

    @classmethod
    def random(cls, rng, n_spheres: int = 4,
               workspace=((0.3, 0.7), (-0.25, 0.25)),
               radius_range=(0.03, 0.07)):
        rng = (np.random.default_rng(rng)
               if not isinstance(rng, np.random.Generator) else rng)
        radii = rng.uniform(*radius_range, size=n_spheres)
        xs = rng.uniform(workspace[0][0], workspace[0][1], size=n_spheres)
        ys = rng.uniform(workspace[1][0], workspace[1][1], size=n_spheres)
        centers = np.stack([xs, ys, radii], axis=-1)  # resting on the plane
        colors = rng.uniform(0.2, 1.0, size=(n_spheres, 3))
        return cls(centers=centers, radii=radii, colors=colors)

    def grasp_pose(self, idx: int = 0) -> np.ndarray:
        """Top-down grasp above sphere `idx`: the gripper's z points down at
        the sphere's top."""
        m = np.eye(4)
        m[:3, :3] = np.diag([1.0, -1.0, -1.0])
        m[:3, 3] = self.centers[idx] + np.array([0.0, 0.0, self.radii[idx]])
        return m

    def trace(self, rays_o: np.ndarray, rays_d: np.ndarray):
        """Intersect rays [..., 3] with the scene. Returns (rgb [..., 3] in
        [0, 1], depth [...] along the ray, hit mask [...])."""
        shape = rays_o.shape[:-1]
        o = rays_o.reshape(-1, 3)
        d = rays_d.reshape(-1, 3)
        n = o.shape[0]
        best_t = np.full(n, np.inf)
        rgb = np.tile(np.asarray(self.background), (n, 1))

        for c, r, col in zip(self.centers, self.radii, self.colors):
            oc = o - c
            b = np.sum(oc * d, axis=-1)
            cterm = np.sum(oc * oc, axis=-1) - r * r
            disc = b * b - cterm
            hit = disc > 0
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = -b - sq
            t2 = -b + sq
            t = np.where(t > 1e-4, t, t2)
            hit &= (t > 1e-4) & (t < best_t)
            if not hit.any():
                continue
            p = o[hit] + t[hit, None] * d[hit]
            normal = (p - c) / r
            shade = 0.25 + 0.75 * np.clip(
                normal @ (-self.light_dir / np.linalg.norm(self.light_dir)),
                0, 1)
            rgb[hit] = np.clip(col * shade[:, None], 0, 1)
            best_t[hit] = t[hit]

        # ground plane z = 0, checkered
        dz = d[:, 2]
        tp = np.where(np.abs(dz) > 1e-8,
                      -o[:, 2] / np.where(np.abs(dz) > 1e-8, dz, 1.0), np.inf)
        hit = (tp > 1e-4) & (tp < best_t)
        if hit.any():
            p = o[hit] + tp[hit, None] * d[hit]
            checker = ((np.floor(p[:, 0] / 0.1) + np.floor(p[:, 1] / 0.1))
                       % 2).astype(int)
            rgb[hit] = np.asarray(self.plane_colors)[checker]
            best_t[hit] = tp[hit]

        depth = np.where(np.isinf(best_t), 0.0, best_t)
        return (rgb.reshape(shape + (3,)).astype(np.float32),
                depth.reshape(shape).astype(np.float32),
                np.isfinite(best_t).reshape(shape))

    def render(self, pose: np.ndarray, intrinsics: np.ndarray,
               height: int, width: int) -> np.ndarray:
        """RGBA uint8 image [H, W, 4] seen from a camera pose."""
        rays_o, rays_d = get_rays_np(width, height, pose, intrinsics)
        rgb, _, _ = self.trace(rays_o, rays_d)
        rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
        return (rgba * 255).astype(np.uint8)


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


def camera_ring(n_perspectives: int, center=(0.5, 0.0, 0.0),
                radius: float = 0.9, polar: float = 0.7, height: int = 480,
                width: int = 640, focal: Optional[float] = None,
                azimuth_span: float = 2 * np.pi):
    """N camera configs {'pose': 4x4, 'intrinsics': 9-flat} on a ring (or an
    arc when `azimuth_span` < 2*pi) looking at `center`. A full ring divides
    by n (0 and 2*pi coincide), an arc by n - 1 to cover its span."""
    if focal is None:
        focal = 0.9 * width
    center = np.asarray(center, np.float64)
    intr = np.array([[focal, 0, width / 2], [0, focal, height / 2],
                     [0, 0, 1]], dtype=np.float64)
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


def generate_views(scene: SyntheticScene, n_perspectives: int,
                   height: int = 480, width: int = 640, **ring_kwargs):
    """The scene from a camera ring -> (colors [P, H, W, 4] uint8, configs)."""
    configs = camera_ring(n_perspectives, height=height, width=width,
                          **ring_kwargs)
    colors = np.stack([
        scene.render(cfg["pose"], cfg["intrinsics"].reshape(3, 3), height,
                     width) for cfg in configs])
    return colors, configs


_COLOR_NAMES = {
    "red": (1.0, 0.2, 0.2), "green": (0.2, 1.0, 0.2), "blue": (0.2, 0.3, 1.0),
    "yellow": (1.0, 1.0, 0.2), "purple": (0.8, 0.2, 1.0),
    "cyan": (0.2, 1.0, 1.0), "orange": (1.0, 0.6, 0.1),
    "white": (1.0, 1.0, 1.0),
}


def color_name(rgb) -> str:
    """The nearest named colour (euclidean in RGB)."""
    names = list(_COLOR_NAMES)
    dists = [np.linalg.norm(np.asarray(rgb) - np.asarray(_COLOR_NAMES[n]))
             for n in names]
    return names[int(np.argmin(dists))]


def grasp_trajectory(grasp_pose_m: np.ndarray, n_poses: int = 10,
                     approach_height: float = 0.2) -> list:
    """A linear top-down approach of `n_poses` poses ending at the grasp
    pose (a descent along world z)."""
    poses = []
    for k in range(n_poses):
        frac = k / (n_poses - 1)
        m = grasp_pose_m.copy()
        m[2, 3] = grasp_pose_m[2, 3] + (1.0 - frac) * approach_height
        poses.append(m)
    return poses


def write_synthetic_dataset(root: str, n_samples: int, n_perspectives: int,
                            height: int = 480, width: int = 640, rng=0,
                            dict_records: bool = False, n_spheres: int = 4,
                            record_order: bool = False, **ring_kwargs) -> str:
    """Write `n_samples` scenes under `root`: colour, camera_config,
    grasp_pose, trajectory, language and info records, and with
    `record_order` the trajectory's length. `dict_records` writes the grasp
    pose and the trajectory as dict records (the language datasets'
    flavour), otherwise as a bare array (npz) and list (pickle)."""
    rng = (np.random.default_rng(rng)
           if not isinstance(rng, np.random.Generator) else rng)
    os.makedirs(root, exist_ok=True)
    for i in range(n_samples):
        scene = SyntheticScene.random(rng, n_spheres=n_spheres)
        colors, configs = generate_views(scene, n_perspectives, height=height,
                                         width=width, **ring_kwargs)
        target = int(rng.integers(n_spheres))
        grasp_m = scene.grasp_pose(target)
        traj = grasp_trajectory(grasp_m)
        lang = f"grasp the {color_name(scene.colors[target])} ball"
        info = {
            f"sphere_{k}": {
                "position": scene.centers[k].tolist(),
                "radius": float(scene.radii[k]),
                "color": scene.colors[k].tolist(),
                "is_target": bool(k == target),
            } for k in range(n_spheres)
        }

        def write(dataset, key, value):
            dataset.write_sample(os.path.join(root, key), i, value)

        write(ColorDataset, "color", colors)
        write(PickleDataset, "camera_config", configs)
        if dict_records:
            write(PickleDataset, "grasp_pose", {"grasp_pose": grasp_m})
            write(PickleDataset, "trajectory", {"trajectory": traj})
        else:
            write(NPZDataset, "grasp_pose", grasp_m)
            write(PickleDataset, "trajectory", traj)
        write(PickleDataset, "language", lang)
        write(PickleDataset, "info", info)
        if record_order:
            write(NPZDataset, "order", np.asarray(len(traj)))
    return root
