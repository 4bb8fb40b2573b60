"""Per-component checkpoints (tcnerf/models/checkpoint.py), in the files
the JAX package reads and writes.

A checkpoint at `path` is one file per component, `<path>_<component>
.msgpack`, each the component's flax params tree as
`flax.serialization.to_bytes` writes it (`models/msgpack_codec.py`,
layouts by `params.to_flax` / `from_flax`), plus the sidecar
`<path>_meta.json` of the model flavour (stage 1 writes it). The reference's
TF tensor bundles (`<path>_<component>.index` + `.data-00000-of-00001`)
load too, and `store_tf` writes them.

    store(path, model, RENDERER_COMPONENTS)
    if not load(path, model, RENDERER_COMPONENTS):   # all or nothing
        ...                                          # nothing was changed

A component is a submodule of the model of that name (`fine_embedding`,
`visual_features`, ...) or a parameter of it (a hash-grid grasp model's
`hash_tables`, which flax writes as one top-level array); names the model
lacks (`hash_tables` on a grasp model without the hash grid,
`combine_clip_visual` on a "without" renderer) are skipped by `store` and
`load` alike. A one-array component has no TF-bundle layout: `store_tf`
and `load_tf` raise on it, as the JAX package's do (its keras key walk
takes a map), after the components before it. `load` copies into the
model's own tensors under `torch.no_grad()` (each on its device and in its
dtype), so parameter objects and the optimizers that hold them stay valid;
it checks every key and shape of every component first and raises
`ValueError` before it changes anything. It is stricter than flax, whose
`from_bytes` ignores keys the file has beyond the target's and keeps a
leaf of another shape (ROADMAP Queue C).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Iterable, List, Mapping, Optional

import torch
from torch import nn

from ..params import from_flax, to_flax
from . import msgpack_codec
from . import tf_checkpoint as tfc

log = logging.getLogger("tcnerf_torch.models")

RENDERER_COMPONENTS = ("coarse_embedding", "coarse_readout",
                       "fine_embedding", "fine_readout", "visual_features",
                       "combine_clip_visual")
RENDERER_WITHOUT_COMPONENTS = ("coarse_embedding", "coarse_readout",
                               "fine_embedding", "fine_readout",
                               "visual_features")
GRASP_COMPONENTS = ("fine_embedding", "visual_features", "grasp_readout",
                    "hash_tables")
BACKBONE_COMPONENTS = ("fine_embedding", "visual_features")

SUFFIX = ".msgpack"


def component_path(path: str, component: str, suffix: str = SUFFIX) -> str:
    return f"{path}_{component}{suffix}"


def _present(model: nn.Module, components: Iterable[str]) -> List[str]:
    """The listed components the model has, in order."""
    return [c for c in components
            if isinstance(getattr(model, c, None), (nn.Module, nn.Parameter))]


def _state(component) -> Dict[str, torch.Tensor]:
    """A component's tensors by `from_flax` key: a module's state dict,
    `{"": parameter}` for a one-array component."""
    if isinstance(component, nn.Module):
        return component.state_dict(keep_vars=True)
    return {"": component}


def store(path: str, model: nn.Module, components: Iterable[str]) -> None:
    """Write each listed component the model has to its msgpack file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    for component in _present(model, components):
        msgpack_codec.write(component_path(path, component),
                            to_flax(getattr(model, component)))


def exists(path: str, components: Iterable[str]) -> bool:
    return all(os.path.exists(component_path(path, c)) for c in components)


def _assign(model: nn.Module, trees: Mapping[str, Mapping],
            path: str) -> None:
    """Copy each component's flax tree into the model's tensors, in place,
    after every key and shape of every component has been checked."""
    staged = []
    for component, tree in trees.items():
        want = _state(getattr(model, component))
        got = from_flax(tree, dtype=None)
        missing = sorted(set(want) - set(got))
        unexpected = sorted(set(got) - set(want))
        shapes = [(k, tuple(got[k].shape), tuple(want[k].shape))
                  for k in want if k in got and got[k].shape != want[k].shape]
        if missing or unexpected or shapes:
            raise ValueError(
                f"checkpoint {component_path(path, component)} does not match"
                f" the model's {component}: missing {missing[:5]} "
                f"({len(missing)}), unexpected {unexpected[:5]} "
                f"({len(unexpected)}), shapes (file, model) {shapes[:5]} "
                f"({len(shapes)})")
        staged.append((want, got))
    with torch.no_grad():
        for want, got in staged:
            for key, tensor in want.items():
                tensor.copy_(got[key])


def load(path: str, model: nn.Module, components: Iterable[str],
         verbose: bool = False) -> bool:
    """Load the listed components the model has from `path`, in place.
    Returns False, and changes nothing, when a file is missing (all or
    nothing); when every msgpack file is missing but every `.index` tensor
    bundle is there, loads those (`load_tf`). Raises ValueError on a key or
    shape that does not match."""
    components = _present(model, components)
    if not exists(path, components):
        if all(os.path.exists(component_path(path, c, ".index"))
               for c in components):
            load_tf(path, model, components)
            return True
        if verbose:
            missing = [c for c in components
                       if not os.path.exists(component_path(path, c))]
            log.info("checkpoint components missing at %s: %s", path, missing)
        return False
    _assign(model, {c: msgpack_codec.read(component_path(path, c))
                    for c in components}, path)
    return True


def _no_array(model: nn.Module, component: str) -> None:
    if isinstance(getattr(model, component), nn.Parameter):
        raise ValueError(f"{component} is one array: the TF-bundle layout "
                         "has keras keys for maps only (the JAX package's "
                         "store_tf / load_tf fail on it too)")


def load_tf(path: str, model: nn.Module, components: Iterable[str]) -> None:
    """Load reference-format (TF tensor-bundle) per-component checkpoints;
    raises ValueError on a missing key or a shape mismatch, and on a
    one-array component."""
    trees = {}
    for c in _present(model, components):
        _no_array(model, c)
        trees[c] = tfc.import_component(component_path(path, c, ""),
                                        to_flax(getattr(model, c)))
    _assign(model, trees, path)


def store_meta(path: str, meta: Dict) -> None:
    """The sidecar `<path>_meta.json`: the model flavour the checkpoint was
    trained with, which the param tree alone cannot show (a v4 decoder
    trained with relu loads cleanly into the elu decoder the grasp stage
    runs)."""
    with open(f"{path}_meta.json", "w") as f:
        json.dump(meta, f)


def load_meta(path: str) -> Optional[Dict]:
    """The sidecar's dict, or None when there is none (no check)."""
    try:
        with open(f"{path}_meta.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def store_tf(path: str, model: nn.Module, components: Iterable[str]) -> None:
    """Write the listed components the model has in the reference's TF
    tensor-bundle layout; raises ValueError at a one-array component."""
    for component in _present(model, components):
        _no_array(model, component)
        tfc.export_component(component_path(path, component, ""),
                             to_flax(getattr(model, component)))
