"""Host-side batch generators (tcnerf/data/generators.py): NeRF ray
batches, the goal EBM's pose batches, the delta-NGF batches (landscape
poses and trajectory windows) and the language batches (delta-NGF plus
CLIP tokens).

Batches are numpy, made with an explicit `np.random.Generator` that draws in
the JAX package's order, so one seed gives the same batches bit for bit;
`to_device` moves one to the card through pinned memory with non-blocking
copies.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.rays import (bbox_biased_sample, gather_target_rgb,
                         get_specific_rays)
from ..tasks.transform import Affine


def camera_parameters(camera_config):
    """{'pose', 'intrinsics' (9-flat)} -> (inverse extrinsics, padded 4x4 K)."""
    intr = np.reshape(camera_config["intrinsics"], (3, 3))
    k4 = np.eye(4)
    k4[:3, :3] = intr
    ext_inv = np.linalg.inv(camera_config["pose"])
    return ext_inv, k4


def u8_to_f32_rgb(image: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C >= 3] -> float32 [H, W, 3] in [0, 1] (k / 255 rounded
    once, from float64)."""
    return (image[..., :3] / 255.0).astype(np.float32)


class DataGenerator:
    """Index-shuffled epoch iteration."""

    def __init__(self, dataset, batch_size=3, shuffle=True, rng=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = (np.random.default_rng(rng)
                    if not isinstance(rng, np.random.Generator) else rng)
        self.indices = self.get_valid_indices()
        self.on_epoch_end()

    def get_valid_indices(self):
        return np.arange(len(self.dataset))

    def on_epoch_end(self):
        if self.shuffle:
            self.rng.shuffle(self.indices)

    def __len__(self):
        return len(self.indices) // self.batch_size

    def __getitem__(self, index):
        batch = self.indices[index * self.batch_size:
                             (index + 1) * self.batch_size]
        return self.get_data(batch)

    def epoch(self):
        """One epoch's batches in order, then the epoch-end shuffle."""
        for i in range(len(self)):
            yield self[i]
        self.on_epoch_end()

    def get_data(self, batch):
        raise NotImplementedError


class MVNeRFDataGenerator(DataGenerator):
    """Ray batches for NeRF training: per scene, n_views source views and
    one target view drawn without replacement, and n_rays_train target
    pixels (80% inside the image box, the reference's bbox-biased draw).
    Returns ((ray_o [B, R, 3], ray_d, src [B, V, H, W, 3] in [0, 1],
    intrinsics [B, V, 4, 4], extrinsics_inv [B, V, 4, 4]), rgb [B, R, 3]).
    The views come from `perspective_pool`, every perspective but
    `exclude_perspectives` (a per-scene field's held-out validation view),
    with the JAX generator's draws for a seed."""

    def __init__(self, dataset, n_rays_train=512, batch_size=1, n_views=2,
                 exclude_perspectives=(), **kwargs):
        super().__init__(dataset, batch_size, **kwargs)
        self.n_rays_train = n_rays_train
        self.n_views = n_views
        self.n_perspectives = self.dataset.datasets["color"].n_perspectives
        self.perspective_pool = np.setdiff1d(
            np.arange(self.n_perspectives),
            np.asarray(exclude_perspectives, dtype=np.int64))

    def generate_rays(self, color, camera_config):
        intr3 = np.reshape(camera_config["intrinsics"],
                           (3, 3)).astype(np.float32)
        pix = bbox_biased_sample(self.rng, self.n_rays_train,
                                 np.array([0, 0, color.shape[0],
                                           color.shape[1]]),
                                 color.shape[0], color.shape[1])
        r_o, r_d = get_specific_rays(pix[:, 1], pix[:, 0],
                                     camera_config["pose"], intr3)
        return r_d, r_o, pix

    @staticmethod
    def get_input(colors, camera_configs, r_d, r_o):
        cams = [camera_parameters(cfg) for cfg in camera_configs]
        # stack uint8, then scale in f32 (not through float64)
        imgs = np.stack(colors).astype(np.float32)
        imgs *= np.float32(1.0 / 255.0)
        return (np.array([r_o], dtype=np.float32),
                np.array([r_d], dtype=np.float32),
                imgs[None],
                np.array([[c[1] for c in cams]], dtype=np.float32),
                np.array([[c[0] for c in cams]], dtype=np.float32))

    def get_data(self, batch):
        parts = [[] for _ in range(5)]
        targets = []
        colors = self.dataset.datasets["color"]
        cameras = self.dataset.datasets["camera_config"]
        for i in batch:
            indices = self.rng.choice(self.perspective_pool,
                                      size=self.n_views + 1, replace=False)
            src_indices, tgt_index = indices[:-1], indices[-1]
            tgt_color = colors.read_sample_at_idx(i, tgt_index)[..., :3]
            r_d, r_o, pix = self.generate_rays(
                tgt_color, cameras.read_sample_at_idx(i, tgt_index))
            targets.append(gather_target_rgb(tgt_color,
                                             np.asarray(pix, np.int32)))
            nn_input = self.get_input(
                [colors.read_sample_at_idx(i, s)[..., :3]
                 for s in src_indices],
                [cameras.read_sample_at_idx(i, s) for s in src_indices],
                r_d, r_o)
            for part, x in zip(parts, nn_input):
                part.extend(x)
        inputs = tuple(np.array(p, dtype=np.float32) for p in parts)
        return inputs, np.array(targets, dtype=np.float32)


def _grasp_view_indices(rng, n_views: int, n_perspectives: int):
    """The source views of a grasp sample: one of {3, 4} for one view,
    {0, 1, 2} for three, any perspective otherwise."""
    if n_views == 1 and n_perspectives >= 5:
        return rng.choice(np.arange(3, 5), size=1, replace=False)
    if n_views == 3 and n_perspectives >= 3:
        return rng.choice(np.arange(0, 3), size=3, replace=False)
    return rng.choice(n_perspectives, size=n_views, replace=False)


def _camera_views(dataset, i, src_indices):
    """Sample i's images [V, H, W, 3] f32, padded intrinsics and inverse
    extrinsics at `src_indices`."""
    colors, intrs, ext_invs = [], [], []
    for s in src_indices:
        colors.append(u8_to_f32_rgb(
            dataset.datasets["color"].read_sample_at_idx(i, s)))
        ext_inv, k4 = camera_parameters(
            dataset.datasets["camera_config"].read_sample_at_idx(i, s))
        ext_invs.append(ext_inv)
        intrs.append(k4)
    return colors, intrs, ext_invs


def _landscape_target(n_points: int) -> np.ndarray:
    """One-hot on the first (the true) pose."""
    return np.concatenate([np.ones(1), np.zeros(n_points - 1)], axis=0)


def _r_negative(pose, rng) -> np.ndarray:
    """`pose` turned by a random nonzero rotation, moved within 1 cm."""
    return pose @ Affine.random(t_bounds=((-0.01, 0.01),) * 3,
                                allow_zero_rotation=False, rng=rng).matrix


class GraspMVNeRFDataGenerator(DataGenerator):
    """The goal EBM's batches: per sample `n_points_train` poses, the true
    grasp first, then uniform negatives in the workspace and negatives
    rotated about the true grasp (1 / n_r_fraction of them). Returns
    ([poses [B, N, 4, 4], src [B, V, H, W, 3], intrinsics, extrinsics_inv],
    one-hot targets [B, N])."""

    def __init__(self, dataset, workspace_bounds, n_views=1,
                 n_points_train=512, batch_size=1, n_r_fraction=4, **kwargs):
        super().__init__(dataset, batch_size, **kwargs)
        self.n_points_train = n_points_train
        self.n_negative = ((n_r_fraction - 1) * n_points_train) // n_r_fraction
        self.n_r_negative = n_points_train - self.n_negative - 1
        self.workspace_bounds = workspace_bounds
        self.n_views = n_views
        self.n_perspectives = self.dataset.datasets["color"].n_perspectives

    def get_data(self, batch):
        poses, targets, srcs, intrs, exts = [], [], [], [], []
        for i in batch:
            src_indices = _grasp_view_indices(self.rng, self.n_views,
                                              self.n_perspectives)
            colors, k4s, ext_invs = _camera_views(self.dataset, i,
                                                  src_indices)
            pose = _read_grasp_pose(self.dataset, i)
            negatives = [Affine.random(self.workspace_bounds,
                                       rng=self.rng).matrix
                         for _ in range(self.n_negative)]
            r_negatives = [_r_negative(pose, self.rng)
                           for _ in range(self.n_r_negative)]
            poses.append([pose, *negatives, *r_negatives])
            targets.append(_landscape_target(self.n_points_train))
            srcs.append(colors)
            intrs.append(k4s)
            exts.append(ext_invs)
        inputs = [np.array(poses, dtype=np.float32),
                  np.array(srcs, dtype=np.float32),
                  np.array(intrs, dtype=np.float32),
                  np.array(exts, dtype=np.float32)]
        return inputs, np.array(targets, dtype=np.float32)


def _read_grasp_pose(dataset, i):
    record = dataset.datasets["grasp_pose"].read_sample(i)
    if isinstance(record, dict):
        record = record["grasp_pose"]
    return np.asarray(record)


def _read_trajectory(dataset, i):
    record = dataset.datasets["trajectory"].read_sample(i)
    if isinstance(record, dict):
        record = record["trajectory"]
    return record


def _pose_rotation(pose_m, rotation_representation: str):
    """A 4x4 pose's rotation as a quaternion (x, y, z, w) or as its first
    two columns (6d)."""
    a = Affine.from_matrix(pose_m)
    if rotation_representation == "quaternion":
        return a.quat
    if rotation_representation == "6d":
        return np.concatenate([a.rotation[:, 0], a.rotation[:, 1]])
    raise ValueError(rotation_representation)


class DeltaNGFDataGenerator(DataGenerator):
    """The delta-NGF batches. Per sample: source views from any
    perspective; landscape poses (the true grasp first, then uniform and
    rotated negatives, or uniform only under `fixed_orientation`) with a
    one-hot target; and a window of `n_future_poses` + 1 trajectory poses,
    each but the last perturbed `pose_augmentation_factor` times, with the
    step to the next pose as the gradient's target. Returns
    ([l_t [B, N, 3], l_r [B, N, 4 | 6], g_t, g_r, src, intrinsics,
    extrinsics_inv], [one-hot [B, N], d_t, d_r])."""

    def __init__(self, dataset, workspace_bounds, n_views=1, batch_size=1,
                 pose_augmentation_factor=1, n_future_poses=5,
                 fixed_orientation=None, rotation_representation="quaternion",
                 **kwargs):
        self.future_poses = n_future_poses
        self.pose_augmentation_factor = pose_augmentation_factor
        super().__init__(dataset, batch_size, **kwargs)
        self.workspace_bounds = workspace_bounds
        self.n_views = n_views
        self.n_perspectives = self.dataset.datasets["color"].n_perspectives
        self.fixed_orientation = fixed_orientation
        self.rotation_representation = rotation_representation
        self.n_points_train = self.future_poses * self.pose_augmentation_factor
        if self.fixed_orientation is not None:
            self.n_negative = self.n_points_train - self.future_poses
            self.n_r_negative = 0
        else:
            n_r_fraction = 8
            self.n_negative = ((n_r_fraction - 1) * self.n_points_train
                               ) // n_r_fraction - self.future_poses
            self.n_r_negative = (self.n_points_train - self.n_negative
                                 - self.future_poses)

    def get_data_camera(self, batch):
        srcs, intrs, exts = [], [], []
        for i in batch:
            src_indices = self.rng.choice(self.n_perspectives,
                                          size=self.n_views, replace=False)
            colors, k4s, ext_invs = _camera_views(self.dataset, i,
                                                  src_indices)
            srcs.append(colors)
            intrs.append(k4s)
            exts.append(ext_invs)
        return (np.array(srcs, dtype=np.float32),
                np.array(intrs, dtype=np.float32),
                np.array(exts, dtype=np.float32))

    def _translations_rotations(self, poses):
        return ([Affine.from_matrix(p).translation for p in poses],
                [_pose_rotation(p, self.rotation_representation)
                 for p in poses])

    def get_data_landscape_final(self, batch):
        trans, rots, targets = [], [], []
        for i in batch:
            target_pose = _read_grasp_pose(self.dataset, i)
            negatives = [
                Affine.random(self.workspace_bounds, rng=self.rng).matrix
                for _ in range(self.n_negative + self.future_poses - 1)]
            r_negatives = [_r_negative(target_pose, self.rng)
                           for _ in range(self.n_r_negative)]
            t, r = self._translations_rotations(
                [target_pose, *negatives, *r_negatives])
            trans.append(t)
            rots.append(r)
            targets.append(_landscape_target(self.n_points_train))
        return (np.array(trans, dtype=np.float32),
                np.array(rots, dtype=np.float32),
                np.array(targets, dtype=np.float32))

    def get_data_grad(self, batch):
        trans, rots, d_t, d_r = [], [], [], []
        for i in batch:
            trajectory = _read_trajectory(self.dataset, i)
            initial = self.rng.integers(
                0, len(trajectory) - self.future_poses - 1)
            window = trajectory[initial:initial + self.future_poses + 1]
            aug_poses, aug_targets = [], []
            for j, pose in enumerate(window[:-1]):
                for _ in range(self.pose_augmentation_factor):
                    aug = Affine.random(t_bounds=((-0.02, 0.02),) * 3,
                                        r_bounds=((-0.6, 0.6),) * 3,
                                        rng=self.rng)
                    input_pose = pose @ aug.matrix
                    target_pose = window[j + 1]
                    if self.fixed_orientation is not None:
                        input_pose, target_pose = (Affine(
                            translation=Affine.from_matrix(p).translation,
                            rotation=self.fixed_orientation).matrix
                            for p in (input_pose, target_pose))
                    aug_poses.append(input_pose)
                    aug_targets.append(target_pose)
            in_t, in_r = self._translations_rotations(aug_poses)
            tg_t, tg_r = self._translations_rotations(aug_targets)
            trans.append(in_t)
            rots.append(in_r)
            d_t.append([t - s for t, s in zip(tg_t, in_t)])
            d_r.append([t - s for t, s in zip(tg_r, in_r)])
        return (np.array(trans, dtype=np.float32),
                np.array(rots, dtype=np.float32),
                np.array(d_t, dtype=np.float32),
                np.array(d_r, dtype=np.float32))

    def get_data(self, batch):
        srcs, intrs, exts = self.get_data_camera(batch)
        l_t, l_r, targets = self.get_data_landscape_final(batch)
        g_t, g_r, d_t, d_r = self.get_data_grad(batch)
        return [l_t, l_r, g_t, g_r, srcs, intrs, exts], [targets, d_t, d_r]


class LanguageDataGenerator(DeltaNGFDataGenerator):
    """The delta-NGF batches plus each sample's instruction as CLIP tokens
    [B, 77] int32 (the port's tokenizer unless `tokenize_fn` is given)."""

    def __init__(self, dataset, workspace_bounds,
                 tokenize_fn: Optional[Callable] = None, **kwargs):
        super().__init__(dataset, workspace_bounds, **kwargs)
        if tokenize_fn is None:
            from ..clip.tokenizer import tokenize as tokenize_fn
        self.tokenize_fn = tokenize_fn

    def get_data_text(self, batch):
        texts = [self.dataset.datasets["language"].read_sample(i)
                 for i in batch]
        return np.array(self.tokenize_fn(texts), dtype=np.int32)

    def get_data(self, batch):
        inputs, targets = super().get_data(batch)
        inputs.append(self.get_data_text(batch))
        return inputs, targets


def to_device(inputs, labels, device: Optional[torch.device]):
    """A numpy batch as tensors on `device`: pinned host copies and
    non-blocking transfers on the card, the arrays themselves on the CPU."""
    def move(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device is None or device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    return tuple(move(a) for a in inputs), move(labels)
