"""Goal-conditioned grasp-EBM training (tcnerf/train/train_goal.py).

    python -m tcnerf_torch.train.train_goal [--config-name=<name>] [key=value ...]

trains the `GraspReadout` of `goal_1_view` on a frozen backbone with the
512-pose landscape loss (`grasp_training.loss`: cross-entropy, or KL
divergence with `grasp_training.loss_reduction` "mean" or "sum"),
validating by pose ascent and the oracle's errors. It runs on the card;
`device=cpu` runs it on the CPU. Datasets are synthesized where
`dataset.path` holds none. The backbone comes from
`grasp_training.backbone_path` (`grasp_common.load_backbone`; seeded from
`seed` where there is none), a run resumes `<model_path>/model_final`, and
the session stores `GRASP_COMPONENTS` to `<model_path>/best` and
`model_final`.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..data.generators import GraspMVNeRFDataGenerator
from ..data.loaders import load_dataset_baseline
from ..device import resolve_device
from ..models import checkpoint as ckpt
from ..models import grasp_training as GT
from .grasp_common import (GraspRun, build_grasp_model, build_pose_optimizer,
                           collect_valid_data, entry, init_grasp_state,
                           load_backbone, make_fit_epochs, prepare_datasets,
                           resume_or_init)
from .session import train_grasp_model


def run_goal_training(cfg, device=None) -> GraspRun:
    """Data, model, train state and validation from `cfg`, then the
    session loop (tcnerf/train/train_goal.py `main`)."""
    dev = resolve_device(device or cfg.get("device"))
    prepare_datasets(cfg, "goal")
    datasets = [load_dataset_baseline(
        path=cfg.dataset.path, n_perspectives=cfg.dataset.n_perspectives,
        dataset_type=split) for split in ("train", "valid")]
    seed = cfg.get("seed", 0)
    data_generator = GraspMVNeRFDataGenerator(
        datasets[0],
        workspace_bounds=[list(b) for b in
                          cfg.generator_grasp.workspace_bounds],
        n_views=cfg.nerf_model.n_views,
        n_points_train=cfg.generator_grasp.n_points_train,
        batch_size=cfg.grasp_training.batch_size,
        n_r_fraction=cfg.generator_grasp.get("n_r_fraction", 4), rng=seed)

    model = build_grasp_model(cfg, device=dev)
    # the JAX trainer initializes its parameters from this batch; drawing it
    # keeps the generator's stream, and so every later batch, the same
    data_generator[0]
    state = init_grasp_state(model, cfg)
    load_backbone(model, cfg)
    resume_or_init(model, cfg)
    pose_optimizer = build_pose_optimizer(model, cfg)
    valid_data = collect_valid_data(datasets[1], cfg, model)

    nt = cfg.grasp_training
    loss_name = nt.get("loss", "cross_entropy")
    loss_reduction = nt.get("loss_reduction", "mean")
    os.makedirs(os.path.join(nt.model_path, "valid"), exist_ok=True)
    history = {"steps": []}

    def step(inputs, labels):
        return GT.grasp_train_step(state, inputs, labels, loss_name,
                                   loss_reduction)[1]

    def store(path):
        ckpt.store(path, model, ckpt.GRASP_COMPONENTS)

    oc = cfg.validation.grasp_opt_config.optimization_config.to_dict()
    history.update(train_grasp_model(
        make_fit_epochs(step, data_generator, dev, history), store,
        nt.n_epochs, nt.eval_after_epochs, nt.model_path,
        os.path.join(nt.model_path, "model_final"), pose_optimizer, oc,
        {"project": "nerf-manipulation", "dir": nt.model_path,
         "config": cfg.to_dict()},
        valid_data, rng=seed))
    return GraspRun(state, history, data_generator, step)


def main(argv: Optional[List[str]] = None):
    return entry(argv, "goal_1_view", run_goal_training)


if __name__ == "__main__":
    main()
