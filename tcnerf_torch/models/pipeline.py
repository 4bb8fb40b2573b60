"""Grasp inference pipeline (tcnerf/models/pipeline.py): encode a scene's
source views once, prepare the pose-independent part of the energy once,
refine thousands of SE(3) guesses by energy ascent, and return the top-k
poses with their scores.

    pipe = GraspPipeline(model=GraspEBM(...).to("cuda"), params=state_dict,
                         workspace_bounds=((0.35, 0.85), (-0.25, 0.25),
                                           (0.0, 0.2)), n_images=3)
    result = pipe.infer(images, intrinsics, extrinsics_inv,
                        text="grasp the red ball", rng=0)
    result.poses[0]  # best Affine

Everything after the host inputs runs on the model's device, in full fp32
(the pipeline pins it, as every entry point does). A pipeline is built from
a model and a state_dict (for example `params.from_flax` of a flax tree,
or None to keep the model's weights), or from checkpoint files either
package wrote:

    pipe = GraspPipeline.from_checkpoints(model, "<grasp run>",
                                          workspace_bounds,
                                          backbone_dir="<stage-1 run>")
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..opt.pose_optimizer import PoseOptimizer
from ..tasks.transform import Affine
from . import checkpoint as ckpt
from .grasp import GraspEBM


@dataclass
class GraspResult:
    poses: List[Affine]            # best first
    scores: List[float]
    duration_s: float
    all_energies: np.ndarray       # [n_guesses]


@dataclass
class GraspPipeline:
    model: GraspEBM
    params: Optional[Dict[str, torch.Tensor]]
    workspace_bounds: object
    n_initial_guesses: int = 4096
    n_images: int = 1
    rotation_representation: str = "quaternion"
    clip_translation: bool = True
    n_optimization_steps: int = 16
    init_lr_t: float = 0.05
    init_lr_r: float = 0.05
    decay_t: float = 0.9
    decay_r: float = 0.09
    sync: bool = True
    tokenize_fn: Optional[object] = None
    top_k: int = 5
    _optimizer: PoseOptimizer = field(default=None, repr=False)

    def __post_init__(self):
        resolve_device(self.device)  # pins fp32: no TF32 convolutions
        if self.params is not None:
            self.model.load_state_dict(self.params, strict=True)
        self.model.eval()

    @classmethod
    def from_checkpoints(cls, model: GraspEBM, model_dir: str,
                         workspace_bounds, backbone_dir: Optional[str] = None,
                         **kwargs) -> "GraspPipeline":
        """A pipeline on `model` (built, on its device) with
        `BACKBONE_COMPONENTS` loaded from `<backbone_dir>/model_final`,
        then `GRASP_COMPONENTS` from `<model_dir>/model_final`, each in
        place where its files are (tcnerf/models/pipeline.py:54-85)."""
        if backbone_dir:
            ckpt.load(os.path.join(backbone_dir, "model_final"), model,
                      ckpt.BACKBONE_COMPONENTS)
        ckpt.load(os.path.join(model_dir, "model_final"), model,
                  ckpt.GRASP_COMPONENTS)
        return cls(model=model, params=None,
                   workspace_bounds=workspace_bounds, **kwargs)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _ensure_optimizer(self) -> PoseOptimizer:
        if self._optimizer is None:
            self._optimizer = PoseOptimizer(
                model=self.model, workspace_bounds=self.workspace_bounds,
                n_initial_guesses=self.n_initial_guesses,
                n_images=self.n_images, n_views=self.model.n_views,
                rotation_representation=self.rotation_representation,
                clip_translation=self.clip_translation,
                init_lr_t=self.init_lr_t, decay_t=self.decay_t,
                init_lr_r=self.init_lr_r, decay_r=self.decay_r)
        return self._optimizer

    def encode(self, images, text: Optional[str] = None) -> torch.Tensor:
        """[1, n_images, H, W, 3] floats in [0, 1] (and a prompt for the
        language variants) -> the feature image [1, n_images, H, W, C]."""
        tokens = None
        if text is not None:
            if self.tokenize_fn is None:
                from ..clip.tokenizer import tokenize
                self.tokenize_fn = tokenize
            tokens = torch.as_tensor(np.asarray(self.tokenize_fn(text),
                                                np.int64), device=self.device)
        images = torch.as_tensor(np.asarray(images, np.float32),
                                 device=self.device)
        with torch.no_grad():
            return self.model.compute_features(images, tokens)

    def infer(self, images, intrinsics, extrinsics_inv,
              text: Optional[str] = None, rng=None) -> GraspResult:
        """Encode, prepare the scene, generate guesses, ascend, top-k."""
        opt = self._ensure_optimizer()
        features = self.encode(images, text)
        inputs = (np.asarray(images, np.float32),
                  np.asarray(intrinsics, np.float32),
                  np.asarray(extrinsics_inv, np.float32))
        start = time.time()
        scene = opt.prepare(inputs, features)
        opt.reset_optimizer()
        state = opt.init_state(opt.generate_initial_guesses(rng))
        phases = ([(True, True)] if self.sync
                  else [(True, False), (False, True)])
        for phase in phases:
            state, _ = opt.optimize_pose(state, scene, phase,
                                         self.n_optimization_steps)
        energies = opt.compute_current_grasp_success(
            state, scene).cpu().numpy().squeeze()
        duration = time.time() - start
        order = np.argsort(energies)[::-1][:self.top_k]
        return GraspResult(poses=opt.get_results(state, order),
                           scores=[float(energies[int(i)]) for i in order],
                           duration_s=duration, all_energies=energies)
