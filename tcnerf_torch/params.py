"""Weight bridge between flax parameter trees and the port, and seeded
initialisation.

`from_flax(tree)` takes a flax `params` tree as nested dicts of numpy
arrays and returns the port's `state_dict` (torch tensors); `to_flax(module)`
is its inverse, bit for bit both ways. The port names
its submodules as the flax modules are named, so a flax path
`a/b/kernel` becomes `a.b.weight`. Layouts:

  Dense kernel [in, out]             -> Linear weight [out, in] (transpose)
  Conv kernel HWIO                   -> OIHW
  ConvTranspose kernel HWIO (`*_deconv`, transpose_kernel=False)
                                     -> [in, out, kh, kw], spatially flipped
  DenseGeneral q/k/v [D, heads, hd]  -> [heads*hd, D]; bias [heads, hd] flat
  DenseGeneral attn_out / out (AttentionPool2d) [heads, hd, D]
                                     -> [D, heads*hd]
  Embed `embedding` [vocab, width]   -> nn.Embedding `weight`, as is
  cls_token, pos_embedding, positional_embedding, text_projection
  ([width, out]), LayerNorm / BatchStatNorm scale and bias, FrozenBatchNorm
  scale / bias / mean / var, hash_tables [levels, 2^T, F]: as is

A component that is one array (a grasp model's top-level `hash_tables`)
is its flax tree by itself: `to_flax(parameter)` is the array and
`from_flax(array)` the state dict `{"": tensor}`.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .utils.profiling import span

# DenseGeneral modules that contract (heads, hd) into the output width
_OUT_PROJECTIONS = ("attn_out", "out")


def _as_tensor(value, dtype) -> torch.Tensor:
    """A leaf (numpy array, or a torch tensor: the codec's bfloat16 leaves)
    as a CPU tensor, cast to `dtype` (a numpy dtype) unless None."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if dtype is None:
            return value
        value = value.float().numpy()
    a = np.asarray(value, dtype=dtype)
    if not a.flags.writeable:            # torch takes no read-only arrays
        a = a.copy()
    return torch.from_numpy(a)


def _convert(path, name: str, value, dtype=np.float32) -> tuple:
    a = _as_tensor(value, dtype)
    module = path[-1] if path else ""
    if name == "kernel":
        if a.ndim == 2:                       # Dense
            a = a.T
        elif a.ndim == 3 and module in _OUT_PROJECTIONS:
            a = a.reshape(-1, a.shape[-1]).T
        elif a.ndim == 3:                     # DenseGeneral q/k/v
            a = a.reshape(a.shape[0], -1).T
        elif a.ndim == 4 and module.endswith("_deconv"):
            a = torch.flip(a, (0, 1)).permute(2, 3, 0, 1)
        elif a.ndim == 4:                     # Conv HWIO -> OIHW
            a = a.permute(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel shape {tuple(a.shape)} at "
                             f"{path}")
        name = "weight"
    elif name == "bias" and a.ndim == 2:      # DenseGeneral q/k/v bias
        a = a.reshape(-1)
    elif name == "embedding":                 # nn.Embed
        name = "weight"
    return name, a.clone(memory_format=torch.contiguous_format)  # copy


def from_flax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """flax params tree (nested dicts of numpy arrays) -> port state_dict
    (in `dtype`: float32, or float64 to carry f64 trees and gradients;
    None keeps each leaf's dtype, as a checkpoint load does). A bare
    array, the tree of a component that is one parameter, gives
    `{"": tensor}`."""
    if not isinstance(tree, Mapping):
        return {"": _convert([], "", tree, dtype)[1]}
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + [key])
            else:
                name, t = _convert(path, key, value, dtype)
                out[".".join(path + [name])] = t

    walk(tree, [])
    return out


_QKV = ("q", "k", "v")


def _heads(module: torch.nn.Module) -> Optional[int]:
    """The heads count of an attention module (ViT and CLIP text blocks,
    AttentionPool2d), whose q/k/v and output projections are flax
    DenseGenerals; None for any other module."""
    n = getattr(module, "num_heads", getattr(module, "heads", None))
    return n if isinstance(n, int) and not isinstance(n, bool) else None


def _leaf(t: torch.Tensor):
    """A CPU copy of `t` as a flax leaf: numpy, or a contiguous
    `torch.bfloat16` tensor, which numpy cannot hold."""
    a = t.detach().cpu().clone(memory_format=torch.contiguous_format)
    return a if a.dtype == torch.bfloat16 else a.numpy()


def to_flax(module: torch.nn.Module) -> Dict:
    """The inverse of `from_flax`: `module`'s state_dict -> the flax params
    tree, nested dicts of numpy arrays in the tensors' dtypes (bfloat16
    leaves stay CPU `torch.bfloat16` tensors); a bare parameter -> its
    array. The module gives
    what a tensor's shape does not: the heads count of a DenseGeneral
    q/k/v ([heads*hd, D] -> [D, heads, hd]; bias [heads, hd]) and output
    projection ([D, heads*hd] -> [heads, hd, D]), and which `weight` is an
    `nn.Embedding`'s (-> `embedding`)."""
    if isinstance(module, torch.Tensor):
        return _leaf(module)
    heads = {name: n for name, m in module.named_modules()
             if (n := _heads(m)) is not None}
    embeds = {name for name, m in module.named_modules()
              if isinstance(m, torch.nn.Embedding)}
    tree: Dict = {}
    for key, value in module.state_dict().items():
        *path, leaf = key.split(".")
        owner, parent = ".".join(path), ".".join(path[:-1])
        sub = path[-1] if path else ""
        n = heads.get(parent) if sub in _QKV + _OUT_PROJECTIONS else None
        a = value.detach().cpu()
        if leaf == "weight" and owner in embeds:
            leaf = "embedding"
        elif leaf == "weight":
            if a.ndim == 2 and n and sub in _QKV:
                a = a.T.reshape(a.shape[1], n, -1)
            elif a.ndim == 2 and n:
                a = a.T.reshape(n, -1, a.shape[0])
            elif a.ndim == 2:
                a = a.T
            elif a.ndim == 4 and sub.endswith("_deconv"):
                a = torch.flip(a.permute(2, 3, 0, 1), (0, 1))
            elif a.ndim == 4:
                a = a.permute(2, 3, 1, 0)
            else:
                raise ValueError(f"unexpected weight shape {tuple(a.shape)} "
                                 f"at {key}")
            leaf = "kernel"
        elif leaf == "bias" and n and sub in _QKV:
            a = a.reshape(n, -1)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _leaf(a)
    return tree


def _dense_init(p: torch.Tensor, kind: str, generator: torch.Generator):
    """flax's glorot_uniform (uniform, limit sqrt(6 / (fan_in + fan_out)))
    or he_normal (normal truncated at 2 std, variance 2 / fan_in) for an
    [out, in] weight."""
    fan_out, fan_in = p.shape
    u = torch.rand(p.shape, generator=generator, device=p.device,
                   dtype=torch.float64)
    if kind == "glorot_uniform":
        p.copy_((2 * u - 1) * math.sqrt(6 / (fan_in + fan_out)))
    elif kind == "he_normal":
        # inverse CDF of the standard normal truncated to [-2, 2]
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
        # flax's scale for the truncation: std / 0.8796...
        p.copy_(z * math.sqrt(2 / fan_in) / .87962566103423978)
    else:
        raise ValueError(f"kernel initializer {kind} not supported")


@span("tcnerf.init_params")
def init_params(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with flax's default scales: weights normal with
    std 1/sqrt(fan_in) (lecun), except a `Dense` that names another flax
    initializer (`kernel_init`: glorot_uniform, he_normal; the grasp
    readout's), biases and BN means zero, norm scales and BN
    variances one, pos_embedding normal(0.02), cls_token zero, and the CLIP
    towers' own initialisers: token embedding normal(0.02), the text
    positional embedding normal(0.01), AttentionPool2d's normal / sqrt(c),
    text_projection normal / sqrt(width), and hash tables uniform in
    +-1e-4 (ops/hashgrid.py `init_hash_params`). In place, on the model's
    device (the generator must be on the same device)."""
    def normal(p, std):
        p.copy_(std * torch.randn(p.shape, generator=generator,
                                  device=p.device))

    kinds = {f"{m}.weight": mod.kernel_init
             for m, mod in model.named_modules()
             if getattr(mod, "kernel_init", "lecun_normal") != "lecun_normal"}
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in kinds:
                _dense_init(p, kinds[name], generator)
            elif name.endswith("token_embedding.weight"):
                normal(p, 0.02)
            elif leaf == "weight":
                if p.dim() == 4 and name.endswith("_deconv.weight"):
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                else:
                    fan_in = math.prod(p.shape[1:])
                normal(p, 1 / math.sqrt(fan_in))
            elif leaf == "pos_embedding":
                normal(p, 0.02)
            elif leaf == "positional_embedding":
                normal(p, p.shape[-1] ** -0.5 if "attnpool" in name else 0.01)
            elif leaf == "text_projection":
                normal(p, p.shape[0] ** -0.5)
            elif leaf == "hash_tables":
                u = torch.rand(p.shape, generator=generator, device=p.device)
                p.copy_((2 * u - 1) * 1e-4)
            elif leaf in ("scale", "var"):
                p.fill_(1.0)
            else:                             # bias, mean, cls_token
                p.zero_()
