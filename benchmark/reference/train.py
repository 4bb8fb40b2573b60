"""Stage-1 training of the reference: the ray batches drawn from a dataset
on disk, and the optimiser.

Batches: the scenes in a shuffled order (shuffled again after each epoch),
per scene one source and one target perspective drawn without replacement,
then 512 target pixels, 80% from the image's box and the rest anywhere
(the box is the whole image), their rays pose @ K^-1 @ (u, v, 1)
normalised, colours k / 255. One numpy stream draws all of it, in that
order. The optimiser: per parameter group (the visual encoder at lr 1e-5,
the rest at 1e-4, each after a linear warm-up read at the update count
before the update) every gradient element clipped to +-1, then Adam (b1
0.9, b2 0.999, eps 1e-8, PyTorch's bias correction).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List

import numpy as np
import torch


def read_scene(root: str, idx: int):
    with np.load(os.path.join(root, "color", f"sample_{idx:08d}.npz")) as z:
        colors = z["colors"]
    with open(os.path.join(root, "camera_config", f"sample_{idx:08d}.pkl"),
              "rb") as f:
        cams = pickle.load(f)
    return colors, cams


def batches(root: str, n_scenes: int, n_perspectives: int, batch_size: int,
            n_rays: int, seed: int) -> Iterator:
    """Endless ((o, d, images, K, extrinsics^-1), labels) numpy batches."""
    rng = np.random.default_rng(seed)
    order = np.arange(n_scenes)
    rng.shuffle(order)
    scenes = {i: read_scene(root, i) for i in range(n_scenes)}
    pool = np.arange(n_perspectives)
    while True:
        for first in range(0, (n_scenes // batch_size) * batch_size,
                           batch_size):
            parts: List[list] = [[] for _ in range(5)]
            labels = []
            for i in order[first:first + batch_size]:
                colors, cams = scenes[int(i)]
                src, tgt = rng.choice(pool, size=2, replace=False)
                image = colors[tgt][..., :3]
                h, w = image.shape[:2]
                n_in = int(n_rays * 0.8)
                pix = np.concatenate([
                    rng.integers([0, 0], [h, w], (n_in, 2)),
                    rng.integers(0, (h, w), size=(n_rays - n_in, 2))])
                k3 = np.reshape(cams[tgt]["intrinsics"], (3, 3)
                                ).astype(np.float32)
                uv1 = np.stack([pix[:, 1].astype(np.float32),
                                pix[:, 0].astype(np.float32),
                                np.ones(n_rays, np.float32)])
                k_inv = np.linalg.inv(k3.astype(np.float64))
                d = (np.asarray(cams[tgt]["pose"])[:3, :3] @ k_inv @ uv1
                     ).T.astype(np.float32)
                d = d / np.linalg.norm(d, axis=1, keepdims=True)
                o = np.broadcast_to(np.asarray(cams[tgt]["pose"], np.float32)
                                    [:3, 3], d.shape)
                labels.append((image[pix[:, 0], pix[:, 1]] / 255.0
                               ).astype(np.float32))
                k4 = np.eye(4)
                k4[:3, :3] = np.reshape(cams[src]["intrinsics"], (3, 3))
                img = colors[src][..., :3].astype(np.float32)
                img *= np.float32(1.0 / 255.0)
                for part, x in zip(parts, (o, d, img[None], k4[None],
                                           np.linalg.inv(cams[src]["pose"])
                                           [None])):
                    part.append(np.asarray(x, np.float32))
            yield (tuple(np.stack(p) for p in parts), np.stack(labels))
            rng.shuffle(order)


def group(name: str) -> str:
    return "feature" if name.startswith("visual_features.") else "nerf"


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lrs: Dict[str, float],
                 warmup: int):
        self.params, self.lrs, self.warmup = params, lrs, warmup
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def lr(self, g: str) -> float:
        c = np.float32(self.count)
        w = np.float32(max(1.0, float(self.warmup)))
        target = np.float32(self.lrs[g])
        return float(c / w * target) if c <= w else float(target)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        k = self.count + 1
        for name, p in self.params.items():
            g = grads[name].clamp(-1.0, 1.0)
            self.m[name].mul_(0.9).add_(g, alpha=0.1)
            self.v[name].mul_(0.999).addcmul_(g, g, value=0.001)
            lr = self.lr(group(name))
            denom = (self.v[name].sqrt() / np.sqrt(1 - 0.999 ** k)).add_(1e-8)
            p.addcdiv_(self.m[name], denom, value=-lr / (1 - 0.9 ** k))
        self.count += 1
