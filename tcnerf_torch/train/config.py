"""The entry points' configurations: the 19 composed configs of
tcnerf/configs (`CONFIGS`: the stage-1 `nerf_1_view_wo`, `nerf_1_view`,
`nerf_3_view`, `nerf_1_view_v4_elu`, the hash-grid fast field's
`nerf_convergence_hashgrid` and `nerf_convergence_hashgrid_cpu`, the grasp
`goal_1_view`, `dngf_1_view`, `dngf_hashgrid`, `trajectory_1_view-1`,
`trajectory_1_view-2`, `language_1_view`, and the convergence runs
`nerf_convergence`, `nerf_convergence_cpu`, `goal_convergence`,
`goal_convergence_cpu`, `language_convergence`,
`language_convergence_cpu`, `dngf_convergence_cpu`) as Python dicts,
dotted `key=value` overrides and `${a.b}` interpolation, as
tcnerf/train/config.py composes them from YAML (this package reads no
YAML: the card's machine has no PyYAML).

Override values are Python literals (`8`, `[48,64]`, `'x'`), `true`,
`false` or `null`; anything else is a string: `data_dir=/tmp/run`.
"""

from __future__ import annotations

import ast
import copy
import re
from typing import Any, Dict, Iterable

def _merge(*parts: Dict) -> Dict:
    """Deep merge, later parts winning (the YAML defaults lists' order)."""
    out: Dict[str, Any] = {}
    for part in parts:
        for k, v in part.items():
            if isinstance(out.get(k), dict) and isinstance(v, dict):
                out[k] = _merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
    return out


# the YAML files of tcnerf/configs, one dict each
_DEFAULT = {
    "ws_dir": "./workspace",
    "data_dir": "./data",
    "torch_weights_path":
        "${data_dir}/storage/transformer_weights/weights.pkl",
    "clip_weights_path": "${data_dir}/storage/clip_weights/RN50.pt",
    "seed": 0,
}
_DEFAULT_NERF = _merge(_DEFAULT, {
    "dataset": {"path": "${data_dir}/storage/data/nerf/simple",
                "n_perspectives": 50},
    "valid_sample_idx": 3,
    "valid_perspective_src_indices": [5, 8, 15],
    "valid_perspective_tgt_idx": 12,
})
_NERF_MODEL = {"n_rays_train": 512, "n_rays_infer": 512, "n_samples": 64,
               "n_features": 256, "near": 0.3, "far": 1.3,
               "original_image_size": [480, 640]}
_NERF_TRAINING = {"n_epochs": 1600, "eval_after_epochs": 16}
_WORKSPACE = {"workspace_bounds": [[0.35, 0.85], [-0.25, 0.25], [0.0, 0.2]]}
_GRASP_TRAINING = {"n_epochs": 400, "eval_after_epochs": 4,
                   "learning_rate": 0.0001, "batch_size": 8}
_VALIDATION = {
    "oracle": {"oracle_type": "suction_grasp-oracle",
               "gripper_offset": {"rotation": [3.14159265359, 0.0,
                                               1.57079632679]}},
    # module names of the JAX package's task plugins, kept as data
    "plugins": {"plugins": ["tcnerf.tasks.plugins.primitives.pick_and_place",
                            "tcnerf.tasks.plugins.objects.base",
                            "tcnerf.tasks.plugins.tasks.grasp_task",
                            "tcnerf.tasks.plugins.oracles.suction_grasp"]},
    "valid_sample_indices": [0, 4, 7],
    "assets_root": "${ws_dir}/assets",
    "disp": False,
    "shared_memory": False,
    "task": "picking-seen-google-objects-seq",
}
_VALIDATION_3_IMAGES = _merge(_VALIDATION, {"grasp_opt_config": {
    "optimizer_config": {"n_initial_guesses": 4096, "n_images": 3,
                         "clip_translation": True},
    "optimization_config": {"n_optimization_steps": 16, "init_lr_t": 0.05,
                            "init_lr_r": 0.05, "decay_t": 0.9,
                            "decay_r": 0.09}}})
_VALIDATION_2_IMAGES = _merge(_VALIDATION, {"grasp_opt_config": {
    "optimizer_config": {"n_initial_guesses": 4096, "n_images": 2,
                         "clip_translation": True},
    "optimization_config": {"n_optimization_steps": 19, "init_lr_t": 0.01776,
                            "init_lr_r": 0.661, "decay_t": 0.8408,
                            "decay_r": 0.8262}}})


def _nerf(n_views: int, training: Dict, model: Dict = None) -> Dict:
    return _merge(_DEFAULT_NERF, {
        "nerf_model": _merge(_NERF_MODEL, {"n_views": n_views}, model or {}),
        "nerf_training": _merge(_NERF_TRAINING, training)})


def _models_path(tail: str) -> str:
    return "${data_dir}/storage/models/" + tail


# nerf_model/hashgrid.yaml: the per-scene fast field
_HASHGRID_MODEL = _merge(_NERF_MODEL, {
    "n_views": 1, "n_rays_train": 4096, "near": 0.55, "far": 1.8,
    "field": "hashgrid", "hashgrid_levels": 16, "hashgrid_table_log2": 14,
    "hashgrid_hidden": 64, "hashgrid_layers": 3,
    "hashgrid_bounds": [[-0.7, 1.7], [-1.2, 1.2], [-0.1, 0.7]],
    "corner_gather": False, "remat": False})


def _hashgrid(tail: str, model: Dict, training: Dict) -> Dict:
    """nerf_convergence_hashgrid{,_cpu}.yaml: one synthetic scene fit by
    the hash-grid field, validated on a held-out view of it."""
    return _merge(_DEFAULT_NERF, {
        "dataset": {"path": "${data_dir}/storage/data/nerf_hashgrid_"
                            + tail + "arc",
                    "n_perspectives": 16, "n_synthetic_samples": 1,
                    "azimuth_span_deg": 100},
        "valid_from_train": True, "valid_sample_idx": 0,
        "nerf_model": _merge(_HASHGRID_MODEL, model),
        "nerf_training": _merge(_NERF_TRAINING, {
            "batch_size": 8, "fusion": "without",
            "model_path": _models_path("nerf/wo/1_view")}, training, {
            "batch_size": 1, "learning_rate": 1.0e-2,
            "feature_learning_rate": 1.0e-2, "warmup_steps": 8})})


# the composed configs (tcnerf/configs/<name>.yaml)
CONFIGS: Dict[str, Dict[str, Any]] = {
    "nerf_1_view_wo": _nerf(1, {"batch_size": 8, "fusion": "without",
                                "model_path": _models_path("nerf/wo/1_view")}),
    "nerf_1_view": _nerf(1, {"batch_size": 1, "fusion": "v0",
                             "model_path": _models_path("nerf/v0/1_view")}),
    "nerf_3_view": _nerf(3, {"batch_size": 8, "fusion": "v0",
                             "model_path": _models_path("nerf/v0/3_view")}),
    "nerf_1_view_v4_elu": _nerf(
        1, {"batch_size": 1, "fusion": "v4",
            "model_path": _models_path("nerf/v4_w_elu/1_view")},
        {"fusion_use_dense": True, "fusion_activation": "elu"}),
    "goal_1_view": _merge(_DEFAULT, {
        "dataset": {"path": "${data_dir}/storage/data/goal/simple",
                    "n_perspectives": 5},
        "grasp_model": {"n_5d_poses": 7},
        "generator_grasp": _merge(_WORKSPACE, {"n_points_train": 512,
                                               "n_r_fraction": 32}),
        "nerf_model": _merge(_NERF_MODEL, {"n_views": 1}),
        "grasp_training": _merge(_GRASP_TRAINING, {
            "model_path": _models_path("grasp/simple/goal_1_view"),
            "backbone_path": _models_path("nerf/simple/1_view"),
            "loss": "kl_divergence", "readout_flavor": "goal"}),
        "validation": _VALIDATION_3_IMAGES}),
    "dngf_1_view": _merge(_DEFAULT, {
        "dataset": {"path": "${data_dir}/storage/data/grasp_baseline_grad/"
                            "simple",
                    "n_perspectives": 5, "record_grasp_pose": True,
                    "record_order": True},
        "nerf_model": _merge(_NERF_MODEL, {"n_views": 1}),
        "grasp_model": {"n_5d_poses": 7,
                        "rotation_representation": "quaternion"},
        "generator_grasp": _merge(_WORKSPACE, {"pose_augmentation_factor": 16,
                                               "n_future_poses": 4}),
        "grasp_training": _merge(_GRASP_TRAINING, {
            "model_path": _models_path("grasp/dngf/1_view"),
            "backbone_path": _models_path("nerf/simple/1_view"),
            "loss": "cross_entropy", "readout_bias": True}),
        "validation": _VALIDATION_2_IMAGES}),
    "nerf_convergence_hashgrid": _hashgrid("", {}, {
        "model_path": _models_path("nerf/hashgrid"), "n_epochs": 2048,
        "eval_after_epochs": 128, "scale_down_after": 1500}),
    "nerf_convergence_hashgrid_cpu": _hashgrid("cpu_", {
        "original_image_size": [240, 320], "n_samples": 32,
        "n_rays_train": 1024, "hashgrid_finest_res": 256}, {
        "model_path": _models_path("nerf/hashgrid_cpu"), "n_epochs": 1024,
        "eval_after_epochs": 64, "scale_down_after": 768}),
    **{f"trajectory_1_view-{k}": _merge(_DEFAULT, {
        "dataset": {"path": "${data_dir}/storage/data/trajectory/simple",
                    "n_perspectives": 5},
        "generator_grasp": _merge(_WORKSPACE, {"pose_augmentation_factor": 32,
                                               "n_future_poses": 6}),
        "nerf_model": _merge(_NERF_MODEL, {"n_views": 1}),
        "grasp_training": _merge(_GRASP_TRAINING, {
            "model_path": _models_path("grasp/simple/" + tail),
            "backbone_path": _models_path("nerf/simple/1_view"),
            "loss": "kl_divergence", "readout_bias": True}),
        "validation": _VALIDATION_3_IMAGES,
        "grasp_model": {"n_5d_poses": 7, "rotation_representation": rep}})
       for k, tail, rep in ((1, "trajectory_1_view", "6d"),
                            (2, "trajectory_1_view-2", "quaternion"))},
    "language_1_view": _merge(_DEFAULT, {
        "dataset": {"path": "${data_dir}/storage/data/language/simple",
                    "n_perspectives": 50},
        "generator_grasp": _merge(_WORKSPACE, {"pose_augmentation_factor": 32,
                                               "n_future_poses": 6}),
        "nerf_model": _merge(_NERF_MODEL, {"n_views": 1}),
        "grasp_model": {"n_5d_poses": 7, "rotation_representation": "6d"},
        "grasp_training": _merge(_GRASP_TRAINING, {
            "model_path": _models_path("grasp/v4_w_elu-val/language_1_view"),
            "backbone_path": _models_path("nerf/v4_w_elu/1_view"),
            "loss": "kl_divergence", "fusion": "v4", "readout_bias": True}),
        "validation": _VALIDATION_3_IMAGES}),
}

# dngf_hashgrid.yaml: dngf_1_view with the hash-grid grasp stream
# (grasp_model/dngf_hashgrid.yaml), whose tables train with the readout
CONFIGS["dngf_hashgrid"] = _merge(CONFIGS["dngf_1_view"], {
    "grasp_model": {"encoding": "hashgrid", "hash_levels": 16,
                    "hash_size_log2": 14, "hash_features": 2,
                    "hash_base_res": 16, "hash_finest_res": 512},
    "grasp_training": {"train_hash_tables": True},
    "n_5d_poses": 7})

# the convergence runs (tcnerf/configs/*_convergence*.yaml): the synthetic
# scenes on a one-sided 100-degree arc, sampled over [0.55, 1.8] where the
# stage-1 model trains; the CPU-sized ones at 96x128 with a small ViT, and
# the grasp runs on the stage-1 convergence runs' backbones
_ARC = {"n_perspectives": 5, "n_synthetic_samples": 64,
        "azimuth_span_deg": 100}
_CPU_MODEL = {"original_image_size": [96, 128], "n_samples": 32,
              "n_rays_train": 256, "n_blocks": 4, "hidden_size": 64,
              "vit_size": [96, 96], "vit_dim": 192, "vit_heads": 4,
              "vit_hooks": [2, 4, 6, 8]}
_CPU_VALIDATION = {"valid_sample_indices": [0, 1, 2, 3], "grasp_opt_config": {
    "optimizer_config": {"n_initial_guesses": 256, "n_images": 2},
    "optimization_config": {"n_optimization_steps": 16}}}
_CPU_GRASP = {"backbone_path": _models_path("nerf/convergence_cpu"),
              "n_epochs": 192, "eval_after_epochs": 8, "batch_size": 2}
_FULL_VALIDATION = {"valid_sample_indices": [0, 1, 2, 3], "grasp_opt_config": {
    "optimizer_config": {"n_initial_guesses": 1024},
    "optimization_config": {"n_optimization_steps": 16}}}


def _data_path(tail: str) -> str:
    return "${data_dir}/storage/data/" + tail


CONFIGS["nerf_convergence"] = _merge(CONFIGS["nerf_1_view_wo"], {
    "dataset": {"path": _data_path("nerf_convergence_arc"),
                "n_perspectives": 16, "n_synthetic_samples": 128,
                "azimuth_span_deg": 100},
    "nerf_model": {"near": 0.55, "far": 1.8},
    "nerf_training": {"model_path": _models_path("nerf/convergence2"),
                      "n_epochs": 2048, "eval_after_epochs": 32,
                      "warmup_steps": 300, "learning_rate": 3.0e-4,
                      "feature_learning_rate": 3.0e-5}})
CONFIGS["nerf_convergence_cpu"] = _merge(CONFIGS["nerf_1_view_wo"], {
    "dataset": {"path": _data_path("nerf_convergence_cpu_arc"),
                "n_perspectives": 8, "n_synthetic_samples": 8,
                "azimuth_span_deg": 100},
    "nerf_model": _merge({"near": 0.55, "far": 1.8}, _CPU_MODEL,
                         {"remat": False}),
    "nerf_training": {"model_path": _models_path("nerf/convergence_cpu"),
                      "n_epochs": 1536, "eval_after_epochs": 64,
                      "batch_size": 2, "warmup_steps": 50,
                      "learning_rate": 1.0e-3,
                      "feature_learning_rate": 1.0e-4},
    "valid_sample_idx": 0, "valid_perspective_src_indices": [1, 2, 3],
    "valid_perspective_tgt_idx": 5})
CONFIGS["goal_convergence"] = _merge(CONFIGS["goal_1_view"], {
    "dataset": _merge(_ARC, {"path": _data_path("goal_convergence_1obj_arc"),
                             "n_spheres": 1}),
    "grasp_training": {"model_path": _models_path("grasp/convergence2"),
                       "backbone_path": _models_path("nerf/convergence2"),
                       "n_epochs": 200, "eval_after_epochs": 8},
    "validation": _FULL_VALIDATION})
CONFIGS["goal_convergence_cpu"] = _merge(CONFIGS["goal_1_view"], {
    "dataset": _merge(_ARC, {
        "path": _data_path("goal_convergence_cpu_1obj_arc"), "n_spheres": 1}),
    "nerf_model": _CPU_MODEL,
    "grasp_model": {"n_5d_poses": 5},
    "generator_grasp": {"n_points_train": 128, "n_r_fraction": 8},
    "grasp_training": _merge(_CPU_GRASP, {
        "model_path": _models_path("grasp/convergence_cpu_1obj")}),
    "validation": _CPU_VALIDATION})
CONFIGS["language_convergence"] = _merge(CONFIGS["language_1_view"], {
    "dataset": _merge(_ARC, {"path": _data_path("language_convergence_arc"),
                             "n_spheres": 4}),
    "grasp_training": {"model_path": _models_path("grasp/language_convergence"),
                       "backbone_path": _models_path("nerf/convergence2"),
                       "train_fusion": True, "n_epochs": 256,
                       "eval_after_epochs": 8, "batch_size": 4},
    "generator_grasp": {"pose_augmentation_factor": 8},
    "validation": _FULL_VALIDATION})
CONFIGS["language_convergence_cpu"] = _merge(CONFIGS["language_1_view"], {
    "dataset": _merge(_ARC, {
        "path": _data_path("language_convergence_cpu_arc"), "n_spheres": 4}),
    "nerf_model": _merge(_CPU_MODEL, {
        "clip_layers": [2, 2, 2, 2], "clip_width": 16, "clip_embed_dim": 128,
        "clip_text_width": 64, "clip_text_layers": 2, "clip_image_size": 64}),
    "grasp_model": {"n_5d_poses": 5},
    "generator_grasp": {"pose_augmentation_factor": 8, "n_future_poses": 4},
    "grasp_training": _merge(_CPU_GRASP, {
        "model_path": _models_path("grasp/language_convergence_cpu"),
        "train_fusion": True}),
    "validation": _CPU_VALIDATION})
CONFIGS["dngf_convergence_cpu"] = _merge(CONFIGS["dngf_1_view"], {
    "dataset": _merge(_ARC, {
        "path": _data_path("dngf_convergence_cpu_1obj_arc"), "n_spheres": 1}),
    "nerf_model": _merge({"near": 0.55, "far": 1.8}, _CPU_MODEL),
    "grasp_model": {"n_5d_poses": 5},
    "generator_grasp": {"n_points_train": 128, "n_r_fraction": 8,
                        "pose_augmentation_factor": 8, "n_future_poses": 4},
    "grasp_training": _merge(_CPU_GRASP, {
        "model_path": _models_path("grasp/dngf_convergence_cpu")}),
    "validation": _merge(_VALIDATION_3_IMAGES, _CPU_VALIDATION)})

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

    def to_dict(self) -> Dict:
        """A plain dict (and lists) copy."""
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o
        return unwrap(self)


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


def load_config(overrides: Iterable[str] = (),
                config_name: str = "nerf_1_view") -> Config:
    """The composed config `config_name` (a key of CONFIGS) with
    `overrides` applied, then interpolated."""
    if config_name not in CONFIGS:
        raise ValueError(f"unknown config {config_name!r}; one of "
                         f"{sorted(CONFIGS)}")
    cfg = apply_overrides(copy.deepcopy(CONFIGS[config_name]), overrides)
    for _ in range(8):                    # nested ${} references
        new = _interpolate(cfg, cfg)
        if new == cfg:
            break
        cfg = new
    return Config.wrap(cfg)


def parse_argv(argv: Iterable[str], config_name: str):
    """CLI arguments -> (config name, overrides): `--config-name=<name>`
    picks the config, as tcnerf/train/config.py `main_config` does; every
    other argument is an override."""
    rest = []
    for a in argv:
        if a.startswith("--config-name="):
            config_name = a.split("=", 1)[1]
        else:
            rest.append(a)
    return config_name, rest
