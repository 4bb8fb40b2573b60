"""CLIP image preprocessing (tcnerf/clip/preprocess.py).

Keeps the JAX package's resize quirk: a landscape [H, W] input resizes to
[224*W/H, 224] (the axes swapped against a shorter-side resize; 480x640
becomes 298x224), a portrait one to [224, 224*H/W]; then a centre crop to
224x224 (both sizes are at least 224: the JAX package's padding branch
never runs) and CLIP's mean/std standardisation. The resize is
jax.image.resize's "cubic" (nn/layers.py `resize_cubic`: Keys a = -0.5,
antialiased, renormalised at the edges). Float images in [0, 1].
"""

from __future__ import annotations

import torch

from ..nn.layers import resize_cubic

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _center_crop(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    start = (x.shape[axis] - target) // 2
    return x.narrow(axis, start, target)


def preprocess(images: torch.Tensor, to_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] float in [0, 1] -> [B, to_size, to_size, 3]
    standardised."""
    _, h, w, _ = images.shape
    if w > h:
        new_h, new_w = int(to_size * w / h), to_size
    else:
        new_h, new_w = to_size, int(to_size * h / w)
    images = resize_cubic(images, (new_h, new_w))
    images = _center_crop(_center_crop(images, 1, to_size), 2, to_size)
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std
