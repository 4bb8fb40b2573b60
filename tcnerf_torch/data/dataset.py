"""Datasets on disk (tcnerf/data/dataset.py), the same layout:

    root/
      color/          sample_00000000.npz  ('colors': [P, H, W, 4] uint8)
      camera_config/  sample_00000000.pkl  (list of {'pose', 'intrinsics'})
      grasp_pose/     sample_00000000.npz  (4x4) or .pkl ({'grasp_pose'})
      trajectory/     sample_00000000.pkl  (list of 4x4, or {'trajectory'})
      language/       sample_00000000.pkl  (str)
      info/           sample_00000000.pkl  (dict)
      order/          sample_00000000.npz  (the trajectory's length)

`SynchronizedDatasets` holds named sub-datasets read by one sample index.
All reads are host-side numpy.
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np


def _sample_file(directory: str, idx: int, ext: str) -> str:
    return os.path.join(directory, f"sample_{idx:08d}.{ext}")


class _FileDataset:
    ext = "npz"

    def __init__(self, directory: str):
        self.directory = directory
        self._len = None

    def __len__(self):
        if self._len is None:
            self._len = (len([f for f in os.listdir(self.directory)
                              if f.startswith("sample_")
                              and f.endswith(self.ext)])
                         if os.path.isdir(self.directory) else 0)
        return self._len

    def read_sample(self, idx: int):
        raise NotImplementedError

    def read_sample_at_idx(self, idx: int, sub_idx: int):
        return self.read_sample(idx)[sub_idx]


class NPZDataset(_FileDataset):
    """One .npz per sample; a lone 'data' key unwraps to the bare array."""

    ext = "npz"

    def read_sample(self, idx: int):
        with np.load(_sample_file(self.directory, idx, "npz"),
                     allow_pickle=False) as z:
            keys = list(z.keys())
            if keys == ["data"]:
                return z["data"]
            return {k: z[k] for k in keys}

    @staticmethod
    def write_sample(directory: str, idx: int, value) -> None:
        os.makedirs(directory, exist_ok=True)
        if isinstance(value, dict):
            np.savez(_sample_file(directory, idx, "npz"), **value)
        else:
            np.savez(_sample_file(directory, idx, "npz"), data=value)


class PickleDataset(_FileDataset):
    """One pickle per sample (dicts, lists, strings). Reads only files this
    package or the JAX package wrote."""

    ext = "pkl"

    def read_sample(self, idx: int):
        with open(_sample_file(self.directory, idx, "pkl"), "rb") as f:
            return pickle.load(f)

    @staticmethod
    def write_sample(directory: str, idx: int, value) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(_sample_file(directory, idx, "pkl"), "wb") as f:
            pickle.dump(value, f)


class MNPZDataset:
    """One monolithic npz: each key holds an array stacked over samples,
    memory-mapped. `key` picks one array; without it a sample is a dict of
    every key's row."""

    def __init__(self, path: str, key: Optional[str] = None):
        self.path = path
        self.key = key
        self._z = np.load(path, mmap_mode="r", allow_pickle=False)
        first = self.key or list(self._z.keys())[0]
        self._len = self._z[first].shape[0]

    def __len__(self):
        return self._len

    def read_sample(self, idx: int):
        if self.key is not None:
            return self._z[self.key][idx]
        return {k: self._z[k][idx] for k in self._z.keys()}

    def read_sample_at_idx(self, idx: int, sub_idx: int):
        return self.read_sample(idx)[sub_idx]

    @staticmethod
    def write(path: str, arrays: Dict[str, np.ndarray]) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **arrays)


class ColorDataset(NPZDataset):
    """Posed RGB(A) captures: per sample an [n_perspectives, H, W, 4] uint8
    array. Samples stay in memory after their first read (least recently
    used first out, up to $TCNERF_DATASET_CACHE_MB MiB, default 512, read
    when the dataset is made), read-only since batches share them:
    decompressing them is most of a batch's host time otherwise."""

    def __init__(self, directory: str, n_perspectives: Optional[int] = None):
        super().__init__(directory)
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cache_budget = int(os.environ.get(
            "TCNERF_DATASET_CACHE_MB", "512")) * 2 ** 20
        self._cache_bytes = 0
        if n_perspectives is None and len(self) > 0:
            n_perspectives = self.read_sample(0).shape[0]
        self.n_perspectives = n_perspectives

    def read_sample(self, idx: int):
        cached = self._cache.get(idx)
        if cached is not None:
            self._cache.move_to_end(idx)
            return cached
        with np.load(_sample_file(self.directory, idx, "npz")) as z:
            colors = z["colors"]
        if colors.nbytes <= self._cache_budget:
            colors.flags.writeable = False
            self._cache[idx] = colors
            self._cache_bytes += colors.nbytes
            while self._cache_bytes > self._cache_budget:
                _, old = self._cache.popitem(last=False)
                self._cache_bytes -= old.nbytes
        return colors

    @staticmethod
    def write_sample(directory: str, idx: int, colors: np.ndarray) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez(_sample_file(directory, idx, "npz"), colors=colors)


class SynchronizedDatasets:
    """Named sub-datasets advanced by a shared sample index."""

    def __init__(self, datasets: Dict[str, object]):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets.values())
