"""Host-side batch generators (tcnerf/data/generators.py, the NeRF part).

Batches are numpy, made with an explicit `np.random.Generator`, exactly as
the JAX package makes them; `to_device` moves one to the card through
pinned memory with non-blocking copies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.rays import (bbox_biased_sample, gather_target_rgb,
                         get_specific_rays)


def camera_parameters(camera_config):
    """{'pose', 'intrinsics' (9-flat)} -> (inverse extrinsics, padded 4x4 K)."""
    intr = np.reshape(camera_config["intrinsics"], (3, 3))
    k4 = np.eye(4)
    k4[:3, :3] = intr
    ext_inv = np.linalg.inv(camera_config["pose"])
    return ext_inv, k4


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
    intrinsics [B, V, 4, 4], extrinsics_inv [B, V, 4, 4]), rgb [B, R, 3])."""

    def __init__(self, dataset, n_rays_train=512, batch_size=1, n_views=2,
                 **kwargs):
        super().__init__(dataset, batch_size, **kwargs)
        self.n_rays_train = n_rays_train
        self.n_views = n_views
        self.n_perspectives = self.dataset.datasets["color"].n_perspectives

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
            indices = self.rng.choice(np.arange(self.n_perspectives),
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


def to_device(inputs, labels, device: Optional[torch.device]):
    """A numpy batch as tensors on `device`: pinned host copies and
    non-blocking transfers on the card, the arrays themselves on the CPU."""
    def move(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device is None or device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    return tuple(move(a) for a in inputs), move(labels)
