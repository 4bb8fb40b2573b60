"""Dataset loaders (tcnerf/data/loaders.py, the NeRF part)."""

from __future__ import annotations

import os

import numpy as np

from .dataset import ColorDataset, PickleDataset, SynchronizedDatasets
from .synthetic import write_synthetic_dataset


def load_dataset_nerf(n_perspectives: int, path: str) -> SynchronizedDatasets:
    """Colour and camera datasets under `path`."""
    return SynchronizedDatasets({
        "color": ColorDataset(os.path.join(path, "color"), n_perspectives),
        "camera_config": PickleDataset(os.path.join(path, "camera_config"))})


def ensure_dataset(path: str, n_perspectives: int, n_samples: int = 8,
                   image_size=(480, 640), rng=0,
                   azimuth_span_deg=None) -> None:
    """Synthesize a NeRF dataset at `path` unless it already holds samples
    (no captured dataset ships with the repository)."""
    color_dir = os.path.join(path, "color")
    if os.path.isdir(color_dir) and any(
            f.startswith("sample_") for f in os.listdir(color_dir)):
        return
    ring = ({} if azimuth_span_deg is None
            else {"azimuth_span": float(azimuth_span_deg) * np.pi / 180})
    write_synthetic_dataset(path, n_samples=n_samples,
                            n_perspectives=n_perspectives,
                            height=image_size[0], width=image_size[1], rng=rng,
                            **ring)
