"""The grasp entry points' shared parts (tcnerf/train/grasp_common.py):
the model, its train state, the backbone and resume guards, the pose
optimizer of the validation, the validation samples with their features,
and `build_oracle`, the configured task-plugin oracle. The entry points
validate with `tasks.agents.OracleAgent`, as the JAX package's do.

`load_backbone` loads the stage-1 backbone (and for a fused model its
decoder) from `<backbone_path>/model_final` and `resume_or_init` resumes
`<model_path>/model_final`, in place, through `models/checkpoint.py`, as
the JAX package's do; a run without a backbone checkpoint keeps the seeded
weights (and raises under `grasp_training.require_backbone`).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..data.prefetch import prefetched_epochs
from ..device import resolve_device
from ..models import checkpoint as ckpt
from ..models import grasp_training as GT
from ..models.grasp import GraspEBM
from ..opt.pose_optimizer import PoseOptimizer
from ..params import init_params
from ..tasks.agents import setup_oracle
from .session import get_inputs

log = logging.getLogger("tcnerf_torch.train")


def build_grasp_model(cfg, fusion: Optional[str] = None,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> GraspEBM:
    """The GraspEBM of `cfg` (tcnerf/train/grasp_common.py:22-79
    `build_grasp_model`): the backbone's widths from `nerf_model`, the probe
    grid from `grasp_model`, and the readout flavour of
    `grasp_training.readout_flavor` ("goal": elu, glorot, bias; otherwise
    the delta-NGF / language flavour: elu, he_normal, the bias from
    `grasp_training.readout_bias`). `corner_gather` follows
    `grasp_training.train_fusion` unless set. A hash-grid `grasp_model`
    (`encoding: hashgrid`) adds the hash stream with its `hash_*` knobs
    over `generator_grasp.workspace_bounds`. The model lives on `device`
    (the card unless the caller passes "cpu"; `device.resolve_device`,
    which also pins fp32) with weights seeded from `cfg.seed`
    (`params.init_params`), as `train_nerf.build_model` seeds the
    renderer."""
    nm = cfg.nerf_model
    gm = cfg.grasp_model
    gt = cfg.grasp_training
    train_fusion = gt.get("train_fusion", False)
    kwargs = dict(
        n_views=nm.n_views, n_features=nm.n_features,
        original_image_size=tuple(nm.original_image_size),
        n_5d_poses=gm.n_5d_poses,
        n_blocks=nm.get("n_blocks", 6),
        hidden_size=nm.get("hidden_size", 128),
        vit_size=tuple(nm.get("vit_size", (224, 224))),
        vit_patch=nm.get("vit_patch", 16), vit_dim=nm.get("vit_dim", 768),
        vit_heads=nm.get("vit_heads", 12),
        vit_hooks=tuple(nm.get("vit_hooks", (3, 6, 9, 12))),
        fusion=fusion,
        clip_layers=tuple(nm.get("clip_layers", (3, 4, 6, 3))),
        clip_width=nm.get("clip_width", 64),
        clip_embed_dim=nm.get("clip_embed_dim", 1024),
        clip_text_width=nm.get("clip_text_width", 512),
        clip_text_layers=nm.get("clip_text_layers", 12),
        clip_image_size=nm.get("clip_image_size", 224),
        remat_fusion=train_fusion,
        corner_gather=gt.get("corner_gather", not train_fusion),
    )
    if gm.get("encoding", "fourier") == "hashgrid":
        kwargs.update(
            hash_encoding=True, hash_levels=gm.get("hash_levels", 16),
            hash_size_log2=gm.get("hash_size_log2", 14),
            hash_features=gm.get("hash_features", 2),
            hash_base_res=gm.get("hash_base_res", 16),
            hash_finest_res=gm.get("hash_finest_res", 512),
            workspace_bounds=tuple(
                tuple(b) for b in cfg.generator_grasp.workspace_bounds))
    if gt.get("readout_flavor", "dngf") == "goal":
        kwargs.update(readout_activation="elu", readout_use_bias=True,
                      readout_kernel_init="glorot_uniform")
    else:
        kwargs.update(readout_activation="elu",
                      readout_kernel_init="he_normal",
                      readout_use_bias=gt.get("readout_bias", False))
    dev = resolve_device(device)
    model = GraspEBM(**kwargs).to(dev)
    init_params(model, torch.Generator(device=dev).manual_seed(
        cfg.get("seed", 0)))
    return model


def init_grasp_state(model: GraspEBM, cfg, trainable=("grasp_readout",)
                     ) -> GT.GraspTrainState:
    """The train state of a built (seeded) model: `trainable` components
    train at `grasp_training.learning_rate`, the rest is frozen."""
    return GT.create_grasp_train_state(
        model, learning_rate=cfg.grasp_training.learning_rate,
        trainable=trainable)


def load_backbone(model: GraspEBM, cfg, fusion: bool = False):
    """The frozen stage-1 backbone at `<backbone_path>/model_final`, in
    place (tcnerf/train/grasp_common.py:91-163, branch for branch). Under
    `fusion` the stage-1 fusion decoder (`combine_clip_visual`) comes with
    it when the sidecar `model_final_meta.json` names a v3/v4 decoder of
    the language flavour (dense text gate, elu) or there is no sidecar; a
    flavour mismatch warns (raises ValueError under
    `grasp_training.require_backbone`) and a decoder whose keys or shapes
    do not match warns; both then load the bare backbone. Without a
    backbone the seeded weights stay, with a warning, unless
    `require_backbone` asks for the reference's FileNotFoundError. Returns
    (model, loaded)."""
    require = cfg.grasp_training.get("require_backbone", False)
    backbone = os.path.join(cfg.grasp_training.backbone_path, "model_final")
    meta = ckpt.load_meta(backbone)
    if fusion:
        flavor_ok = True
        if meta is not None and meta.get("fusion") not in ("v3", "v4"):
            flavor_ok = False
            log.info("Backbone at %s is fusion=%r (no stage-1 fusion "
                     "decoder); loading the bare backbone.", backbone,
                     meta.get("fusion"))
        elif meta is not None:
            want = {"fusion_use_dense": True, "fusion_activation": "elu"}
            mismatches = {k: (meta.get(k), v) for k, v in want.items()
                          if meta.get(k) != v}
            if mismatches:
                flavor_ok = False
                msg = (f"Backbone at {backbone} was trained with the wrong "
                       f"fusion-decoder flavor for the language stage (got "
                       f"vs want: {mismatches}); the param trees may still "
                       f"coincide, so this would train with the wrong "
                       f"nonlinearity.")
                if require:
                    raise ValueError(msg)
                log.warning("%s Falling back to the bare backbone.", msg)
        loaded = False
        if flavor_ok:
            try:
                loaded = ckpt.load(backbone, model, ckpt.BACKBONE_COMPONENTS
                                   + ("combine_clip_visual",))
            except ValueError as e:
                log.warning("Fusion decoder at %s does not match this "
                            "model's parameters: %s", backbone, e)
        if loaded:
            log.info("Backbone (+fusion decoder) loaded from %s.", backbone)
            return model, True
        log.warning("No fusion decoder at %s (or shape mismatch); trying the "
                    "bare backbone.", backbone)
    if ckpt.load(backbone, model, ckpt.BACKBONE_COMPONENTS):
        log.info("Backbone loaded from %s.", backbone)
        return model, True
    if require:
        raise FileNotFoundError(
            f"Backbone not found at {backbone} and "
            "grasp_training.require_backbone=true")
    log.warning("Backbone not found at %s; using the seeded backbone.",
                backbone)
    return model, False


def resume_or_init(model: GraspEBM, cfg, extra_components=()) -> GraspEBM:
    """Resume from `<model_path>/model_final`, in place: the grasp
    components with `extra_components` (e.g. `combine_clip_visual` of a
    fused model) where the checkpoint has them, else the grasp components
    alone (tcnerf/train/grasp_common.py:166-180); without a checkpoint the
    model stays as it is."""
    checkpoint = os.path.join(cfg.grasp_training.model_path, "model_final")
    for components in (ckpt.GRASP_COMPONENTS + tuple(extra_components),
                       ckpt.GRASP_COMPONENTS):
        if ckpt.load(checkpoint, model, components):
            log.info("Model loaded from %s (%d component groups).",
                     checkpoint, len(components))
            return model
        if not extra_components:
            break
    return model


def build_pose_optimizer(model: GraspEBM, cfg) -> PoseOptimizer:
    """The validation's pose optimizer from `validation.grasp_opt_config.
    optimizer_config`, on the trained model itself."""
    oc = cfg.validation.grasp_opt_config.optimizer_config
    return PoseOptimizer(
        model=model,
        workspace_bounds=[list(b) for b in
                          cfg.generator_grasp.workspace_bounds],
        n_initial_guesses=oc.n_initial_guesses, n_images=oc.n_images,
        n_views=cfg.nerf_model.n_views,
        rotation_representation=cfg.grasp_model.get("rotation_representation",
                                                    "quaternion"),
        clip_translation=oc.get("clip_translation", False))


def make_compute_features(model: GraspEBM):
    """compute(observations [1, n, H, W, 3], tokens or None) -> the
    model's features on the host (numpy), without autograd. The images are
    rounded to f32 (as JAX's `compute` casts them), then carried in the
    model's dtype."""
    def compute(observations, tokens):
        p = next(model.parameters())
        images = torch.as_tensor(np.asarray(observations, np.float32),
                                 device=p.device).to(p.dtype)
        tok = None if tokens is None else torch.as_tensor(
            np.asarray(tokens, np.int64), device=p.device)
        with torch.no_grad():
            return model.compute_features(images, tok).cpu().numpy()

    return compute


def build_oracle(cfg):
    """The oracle of `validation.oracle`, after loading the task plugins of
    `validation.plugins` (tcnerf/train/grasp_common.py `build_oracle`): for
    the composed grasp configs the suction oracle, which
    `session.get_step_results` scores through `OracleAgent`."""
    validation = cfg.get("validation", {})
    return setup_oracle(validation.get("plugins"), validation.get("oracle"))


def collect_valid_data(valid_dataset, cfg, model: GraspEBM, tokenize_fn=None,
                       defer_features: bool = False):
    """The validation samples of `validation.valid_sample_indices`, each
    (input_data, features on the host, task info, true grasp pose). With
    `defer_features` only the first sample (the warm-up's) gets features
    now; the session's `refresh_valid_fn` fills the rest."""
    n_images = int(cfg.validation.grasp_opt_config.optimizer_config.n_images)
    fn = make_compute_features(model)
    out = []
    for k, i in enumerate(cfg.validation.valid_sample_indices):
        feat_fn = fn if (k == 0 or not defer_features) else (
            lambda obs, tok: None)
        out.append(get_inputs(valid_dataset, i, n_images, feat_fn,
                              tokenize_fn))
    return out


class GraspRun(NamedTuple):
    """What a grasp trainer returns: its train state, its history (per
    step its metrics and host seconds, `data_s` waiting for the batch and
    `step_s` the whole step until its metrics reached the host; per
    validation its epoch, logged errors and seconds), its data generator
    and its `step(inputs, labels) -> metrics`, the one the session loop
    took."""
    state: GT.GraspTrainState
    history: Dict[str, List]
    data_generator: Any
    step: Callable


def make_fit_epochs(step: Callable, data_generator, device: torch.device,
                    history: Dict[str, List]) -> Callable[[int, int], None]:
    """fit(initial_epoch, end_epoch) for the session loop: the epochs'
    batches through `prefetched_epochs` onto `device`, each taken by
    `step(inputs, labels) -> metrics`, whose values are read on the host
    (which ends the step's clock) and kept in `history["steps"]`."""
    def fit(i_epoch: int, e_epoch: int) -> None:
        batches = iter(prefetched_epochs(data_generator, e_epoch - i_epoch,
                                         device))
        values: Dict[str, float] = {}
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t_data = time.perf_counter() - t0
            values = {k: float(v) for k, v in step(*batch).items()}
            history["steps"].append(dict(
                values, data_s=t_data, step_s=time.perf_counter() - t0))
        log.info("epoch %d: %s", e_epoch,
                 " ".join(f"{k}={v:.5f}" for k, v in values.items()))

    return fit


def prepare_datasets(cfg, kind: str) -> None:
    """Synthesize the `train` (`dataset.n_synthetic_samples`, default 8,
    seed 0) and `valid` (8, seed 1) datasets of `kind` under
    `dataset.path` where none are, as the JAX entry points do."""
    from ..data.loaders import ensure_dataset
    for split, n, seed in (("train",
                            cfg.dataset.get("n_synthetic_samples", 8), 0),
                           ("valid", 8, 1)):
        ensure_dataset(os.path.join(cfg.dataset.path, split),
                       cfg.dataset.n_perspectives, kind,
                       image_size=tuple(cfg.nerf_model.original_image_size),
                       n_samples=n, rng=seed,
                       n_spheres=cfg.dataset.get("n_spheres", 4),
                       azimuth_span_deg=cfg.dataset.get("azimuth_span_deg"))


def entry(argv: Optional[List[str]], config_name: str, run: Callable):
    """A trainer's CLI: `--config-name=` and overrides from `argv`
    (default sys.argv), logging to stderr, then `run(cfg)` (on the card
    unless `device=cpu` is among the overrides)."""
    import sys

    from .config import load_config, parse_argv
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(message)s")
    name, overrides = parse_argv(sys.argv[1:] if argv is None else argv,
                                 config_name)
    return run(load_config(overrides, name))
