"""Dataset loaders (tcnerf/data/loaders.py): the sub-datasets each entry
point reads, and `ensure_dataset`, which synthesizes a dataset where none
is (no captured dataset ships with the repository)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .dataset import (ColorDataset, NPZDataset, PickleDataset,
                      SynchronizedDatasets)
from .synthetic import write_synthetic_dataset


def _open(root: str, n_perspectives: Optional[int] = None,
          keys=("color", "camera_config")) -> SynchronizedDatasets:
    """The sub-datasets `keys` under `root`. `grasp_pose` and `order` are
    pickles where the writer made dict records (language datasets), npz
    otherwise."""
    datasets = {}
    for key in keys:
        directory = os.path.join(root, key)
        if key == "color":
            datasets[key] = ColorDataset(directory, n_perspectives)
        elif key in ("camera_config", "language", "info", "trajectory"):
            datasets[key] = PickleDataset(directory)
        elif key in ("grasp_pose", "order"):
            pkl = PickleDataset(directory)
            datasets[key] = pkl if len(pkl) > 0 else NPZDataset(directory)
        else:
            datasets[key] = NPZDataset(directory)
    return SynchronizedDatasets(datasets)


def load_dataset_nerf(n_perspectives: int, path: str) -> SynchronizedDatasets:
    """Colour and camera datasets under `path`."""
    return _open(path, n_perspectives, keys=("color", "camera_config"))


def load_dataset_language(n_perspectives: int,
                          path: str) -> SynchronizedDatasets:
    return _open(path, n_perspectives,
                 keys=("color", "camera_config", "grasp_pose", "trajectory",
                       "language", "info"))


def load_dataset_baseline(path: str, n_perspectives: int,
                          dataset_type: str = "train") -> SynchronizedDatasets:
    return _open(os.path.join(path, dataset_type), n_perspectives,
                 keys=("color", "camera_config", "grasp_pose", "info"))


def load_dataset(path: str, n_perspectives: int,
                 record_grasp_pose: bool = False, record_order: bool = False,
                 dataset_type: str = "train") -> SynchronizedDatasets:
    keys = ["color", "camera_config", "trajectory", "info"]
    if record_grasp_pose:
        keys.append("grasp_pose")
    if record_order:
        keys.append("order")
    return _open(os.path.join(path, dataset_type), n_perspectives,
                 keys=tuple(keys))


def ensure_dataset(path: str, n_perspectives: int, kind: str = "nerf",
                   n_samples: int = 8, image_size=(480, 640), rng=0,
                   n_spheres: int = 4, azimuth_span_deg=None,
                   **ring_kwargs) -> None:
    """Synthesize a dataset at `path` unless it already holds samples.
    `kind` "language" writes dict records, "grad" the trajectory's order."""
    color_dir = os.path.join(path, "color")
    if os.path.isdir(color_dir) and any(
            f.startswith("sample_") for f in os.listdir(color_dir)):
        return
    if azimuth_span_deg is not None:
        ring_kwargs["azimuth_span"] = float(azimuth_span_deg) * np.pi / 180
    write_synthetic_dataset(
        path, n_samples=n_samples, n_perspectives=n_perspectives,
        height=image_size[0], width=image_size[1], rng=rng,
        n_spheres=n_spheres, dict_records=(kind == "language"),
        record_order=(kind == "grad"), **ring_kwargs)
