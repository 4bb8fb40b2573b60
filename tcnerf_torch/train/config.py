"""The trainer's configuration: the composed `nerf_1_view_wo` config of
tcnerf/configs (default_nerf + nerf_model/1_view + nerf_training/1_view_wo)
as a Python dict, dotted `key=value` overrides and `${a.b}` interpolation,
as tcnerf/train/config.py composes it from YAML (this package reads no
YAML: the card's machine has no PyYAML).

Override values are Python literals (`8`, `[48,64]`, `'x'`), `true`,
`false` or `null`; anything else is a string: `data_dir=/tmp/run`.
"""

from __future__ import annotations

import ast
import copy
import re
from typing import Any, Dict, Iterable

NERF_1_VIEW_WO: Dict[str, Any] = {
    "ws_dir": "./workspace",
    "data_dir": "./data",
    "torch_weights_path":
        "${data_dir}/storage/transformer_weights/weights.pkl",
    "clip_weights_path": "${data_dir}/storage/clip_weights/RN50.pt",
    "seed": 0,
    "dataset": {"path": "${data_dir}/storage/data/nerf/simple",
                "n_perspectives": 50},
    "valid_sample_idx": 3,
    "valid_perspective_src_indices": [5, 8, 15],
    "valid_perspective_tgt_idx": 12,
    "nerf_model": {"n_rays_train": 512, "n_rays_infer": 512, "n_samples": 64,
                   "n_features": 256, "near": 0.3, "far": 1.3,
                   "original_image_size": [480, 640], "n_views": 1},
    "nerf_training": {"n_epochs": 1600, "eval_after_epochs": 16,
                      "batch_size": 8, "fusion": "without",
                      "model_path": "${data_dir}/storage/models/nerf/wo/1_view"},
}

_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")
_WORDS = {"true": True, "false": False, "null": None}


class Config(dict):
    """dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj


def parse_value(text: str) -> Any:
    if text in _WORDS:
        return _WORDS[text]
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(cfg: Dict, overrides: Iterable[str]) -> Dict:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must look like key=value, got {ov!r}")
        key, _, value = ov.partition("=")
        parts = key.lstrip("+").split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_value(value)
    return cfg


def _lookup(cfg: Dict, dotted: str):
    node: Any = cfg
    for p in dotted.split("."):
        node = node[p]
    return node


def _interpolate(cfg: Dict, node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _interpolate(cfg, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(cfg, v) for v in node]
    if isinstance(node, str):
        full = _INTERP.fullmatch(node)
        if full:
            return _lookup(cfg, full.group(1))
        return _INTERP.sub(lambda m: str(_lookup(cfg, m.group(1))), node)
    return node


def load_config(overrides: Iterable[str] = ()) -> Config:
    """The composed config with `overrides` applied, then interpolated."""
    cfg = apply_overrides(copy.deepcopy(NERF_1_VIEW_WO), overrides)
    for _ in range(8):                    # nested ${} references
        new = _interpolate(cfg, cfg)
        if new == cfg:
            break
        cfg = new
    return Config.wrap(cfg)
