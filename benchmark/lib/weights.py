"""Seeded weights, made by the benchmark on the card in a few large calls.

The program and the plain reference get the same tensors by name: the
benchmark draws one uniform block for all of a model's parameters and
scales each part: a matrix by its fan-in (variance 1 / fan_in, as flax's
lecun default), a layer's bias uniform within 1 / sqrt(fan_in) of its
matrix (as torch.nn.Linear's default), a norm's scale 1 +- 0.1 and its
shift +- 0.1, and the ViT's position embedding and class token a small
draw. No bias is zero and no scale one, so a bias or an affine term that
the program drops or adds twice moves its outputs. Only a parameter's name
and shape decide its draw, so two models with the same parameter names and
shapes get the same weights from one seed.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def _fan_in(name: str, shape: Tuple[int, ...]) -> int:
    if len(shape) == 4 and name.endswith("_deconv.weight"):
        return shape[0]                   # [in, out, kh, kw], stride = kernel
    return math.prod(shape[1:])           # Linear [out, in], Conv OIHW


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) >= 2:
        return "matrix"
    if leaf in ("pos_embedding", "cls_token"):
        return "embedding"
    if leaf == "scale":
        return "scale"
    return "shift"                         # biases, norm shifts


def _half_width(name: str, shape, shapes: Dict[str, Tuple[int, ...]]
                ) -> float:
    """Half the width of the uniform draw of one parameter."""
    kind = _kind(name, shape)
    if kind == "matrix":
        return math.sqrt(3.0 / _fan_in(name, shape))  # a^2 / 3 = 1 / fan_in
    if kind == "embedding":
        return 0.02 * math.sqrt(3.0)
    if kind == "scale":
        return 0.1
    matrix = name.rsplit(".", 1)[0] + ".weight"
    if matrix in shapes and len(shapes[matrix]) >= 2:
        return 1.0 / math.sqrt(_fan_in(matrix, shapes[matrix]))
    return 0.1                             # a norm's shift


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} for (name, shape) pairs, drawn from `seed` on
    `device` in one uniform call; names sorted, so that the order in which
    a model lists its parameters does not move a draw."""
    shapes = sorted((n, tuple(s)) for n, s in shapes)
    by_name = dict(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32).mul_(2).sub_(1)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in shapes:
        n = math.prod(shape)
        x = flat[offset:offset + n].view(shape).mul(
            _half_width(name, shape, by_name))
        if _kind(name, shape) == "scale":
            x = x.add_(1.0)
        out[name] = x.to(dtype)
        offset += n
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
    """Copy `weights` into every parameter of `module`, by name, in place;
    a parameter without a weight, or a weight without a parameter, raises."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(weights))
    extra = sorted(set(weights) - set(params))
    if missing or extra:
        raise KeyError(f"weights do not match the module: missing "
                       f"{missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def for_module(module: torch.nn.Module, seed: int, device
               ) -> Dict[str, torch.Tensor]:
    return make_weights(((n, p.shape) for n, p in module.named_parameters()),
                        seed, device)


def drop_biases(module: torch.nn.Module,
                suffix: str = "feature_block_0.layer_1.bias") -> int:
    """Zeroes the program's biases whose names end in `suffix` (a hidden
    layer of each MLP chain): the fault of a kernel that drops a bias, for
    the harness's tests. Returns how many were zeroed."""
    n = 0
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(suffix):
                p.zero_()
                n += 1
    if not n:
        raise KeyError(f"no parameter ends in {suffix!r}")
    return n
