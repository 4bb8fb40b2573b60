"""Gradient-supervised grasp-field training (tcnerf/train/train_delta_ngf.py).

    python -m tcnerf_torch.train.train_delta_ngf [--config-name=<name>] [key=value ...]

trains the delta-NGF energy head of `dngf_1_view` with the landscape loss
plus the second-order gradient supervision along expert trajectories
(`models/grasp_training.py` `delta_ngf_train_step`); validation runs the
synchronized t + r ascent. `run_delta_training` also drives
`train_trajectory` and `train_language`. It runs on the card; `device=cpu`
runs it on the CPU. Checkpoints as `train_goal`'s, with
`combine_clip_visual` beside `GRASP_COMPONENTS` for a fused model.
`--config-name=dngf_hashgrid` trains the hash-grid grasp field
(`grasp_model.encoding: hashgrid`): with `grasp_training.train_hash_tables`
its `hash_tables` train with the readout, and are stored, loaded and
resumed as a component of their own.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..data.generators import DeltaNGFDataGenerator
from ..data.loaders import load_dataset, load_dataset_language
from ..device import resolve_device
from ..models import checkpoint as ckpt
from ..models import grasp_training as GT
from .grasp_common import (GraspRun, build_grasp_model, build_pose_optimizer,
                           collect_valid_data, entry, init_grasp_state,
                           load_backbone, make_compute_features,
                           make_fit_epochs, prepare_datasets, resume_or_init)
from .session import train_grasp_model


def run_delta_training(cfg, generator_cls=DeltaNGFDataGenerator, sync=True,
                       fusion=None, tokenize_fn=None, wandb_project="ras24",
                       device=None) -> GraspRun:
    """The delta-NGF trainer (tcnerf/train/train_delta_ngf.py
    `run_delta_training`): with `tokenize_fn` the language datasets and
    the CLIP tokens in each batch; `fusion` builds the CLIP-fused model,
    whose decoder trains too under `grasp_training.train_fusion` (the
    validation features are then recomputed before each validation)."""
    dev = resolve_device(device or cfg.get("device"))
    rotation = cfg.grasp_model.get("rotation_representation", "quaternion")
    prepare_datasets(cfg, "language" if tokenize_fn is not None else "grad")
    if tokenize_fn is not None:
        datasets = [load_dataset_language(
            cfg.dataset.n_perspectives, os.path.join(cfg.dataset.path, split))
            for split in ("train", "valid")]
    else:
        datasets = [load_dataset(
            cfg.dataset.path, cfg.dataset.n_perspectives,
            record_grasp_pose=True,
            record_order=cfg.dataset.get("record_order", False),
            dataset_type=split) for split in ("train", "valid")]
    seed = cfg.get("seed", 0)
    gen_kwargs = dict(
        workspace_bounds=[list(b) for b in
                          cfg.generator_grasp.workspace_bounds],
        n_views=cfg.nerf_model.n_views,
        batch_size=cfg.grasp_training.batch_size,
        pose_augmentation_factor=cfg.generator_grasp.pose_augmentation_factor,
        n_future_poses=cfg.generator_grasp.n_future_poses,
        rotation_representation=rotation, rng=seed)
    if tokenize_fn is not None:
        gen_kwargs["tokenize_fn"] = tokenize_fn
    data_generator = generator_cls(datasets[0], **gen_kwargs)

    model = build_grasp_model(cfg, fusion=fusion, device=dev)
    # the JAX trainer initializes from this batch's pose matrices; drawing
    # it keeps the generator's stream, and so every later batch, the same
    data_generator[0]
    trainable = ("grasp_readout",)
    train_fusion = (fusion is not None
                    and cfg.grasp_training.get("train_fusion", False))
    if train_fusion:
        trainable += ("combine_clip_visual",)
    if (cfg.grasp_model.get("encoding", "fourier") == "hashgrid"
            and cfg.grasp_training.get("train_hash_tables", False)):
        trainable += ("hash_tables",)
    state = init_grasp_state(model, cfg, trainable)
    extras = ("combine_clip_visual",) if fusion is not None else ()
    load_backbone(model, cfg, fusion=fusion is not None)
    resume_or_init(model, cfg, extra_components=extras)
    pose_optimizer = build_pose_optimizer(model, cfg)
    valid_data = collect_valid_data(datasets[1], cfg, model, tokenize_fn,
                                    defer_features=train_fusion)

    nt = cfg.grasp_training
    loss_name = nt.get("loss", "cross_entropy")
    use_tokens = tokenize_fn is not None
    os.makedirs(os.path.join(nt.model_path, "valid"), exist_ok=True)
    history = {"steps": []}

    def step(inputs, labels):
        return GT.delta_ngf_train_step(state, inputs, list(labels),
                                       loss_name, rotation, use_tokens)[1]

    refresh_valid_fn = None
    if train_fusion:
        compute = make_compute_features(model)

        def refresh_valid_fn(valid_data):
            # the decoder trained: the validation features are stale
            return [(inp, compute(inp[0], inp[3]), info, gp)
                    for (inp, _feats, info, gp) in valid_data]

    def store(path):
        ckpt.store(path, model, ckpt.GRASP_COMPONENTS + extras)

    oc = cfg.validation.grasp_opt_config.optimization_config.to_dict()
    oc["sync"] = sync
    history.update(train_grasp_model(
        make_fit_epochs(step, data_generator, dev, history), store,
        nt.n_epochs, nt.eval_after_epochs, nt.model_path,
        os.path.join(nt.model_path, "model_final"), pose_optimizer, oc,
        {"project": wandb_project, "dir": nt.model_path,
         "config": cfg.to_dict()},
        valid_data, rng=seed, refresh_valid_fn=refresh_valid_fn))
    return GraspRun(state, history, data_generator, step)


def main(argv: Optional[List[str]] = None):
    return entry(argv, "dngf_1_view", run_delta_training)


if __name__ == "__main__":
    main()
