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
(the pipeline pins it, as every entry point does). `infer` is the span
"tcnerf.grasp" (`utils/profiling.py`), and its parts are spans under it:
"tcnerf.grasp.encode", ".prepare", ".guesses", ".step" (each ascent step),
".energies" (the final energies to the host) and ".topk".

A pipeline is built from a model and a state_dict (for example
`params.from_flax` of a flax tree, or None to keep the model's weights), or
from checkpoint files either package wrote:

    pipe = GraspPipeline.from_checkpoints(model, "<grasp run>",
                                          workspace_bounds,
                                          backbone_dir="<stage-1 run>")

A demo on a synthetic scene (a tiny seeded `GraspEBM`, or its files from
`model_dir`), on the card unless `--device` names another:

    python -m tcnerf_torch.models.pipeline [model_dir] [--device cpu]
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..opt.pose_optimizer import PoseOptimizer
from ..tasks.transform import Affine
from ..utils.profiling import span
from . import checkpoint as ckpt
from .grasp import GraspEBM


@dataclass
class GraspResult:
    poses: List[Affine]            # best first
    scores: List[float]
    duration_s: float              # host time of the whole `infer` call
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

    @span("tcnerf.grasp.encode")
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
        """Encode, prepare the scene, generate guesses, ascend, top-k.
        The result's `duration_s` is the host time of the whole call."""
        with span("tcnerf.grasp") as whole:
            opt = self._ensure_optimizer()
            features = self.encode(images, text)
            inputs = (np.asarray(images, np.float32),
                      np.asarray(intrinsics, np.float32),
                      np.asarray(extrinsics_inv, np.float32))
            scene = opt.prepare(inputs, features)
            with span("tcnerf.grasp.guesses"):
                opt.reset_optimizer()
                state = opt.init_state(opt.generate_initial_guesses(rng))
            phases = ([(True, True)] if self.sync
                      else [(True, False), (False, True)])
            for phase in phases:
                state, _ = opt.optimize_pose(state, scene, phase,
                                             self.n_optimization_steps)
            with span("tcnerf.grasp.energies"):
                energies = opt.compute_current_grasp_success(
                    state, scene).cpu().numpy().squeeze()
            with span("tcnerf.grasp.topk"):
                order = np.argsort(energies)[::-1][:self.top_k]
                result = GraspResult(
                    poses=opt.get_results(state, order),
                    scores=[float(energies[int(i)]) for i in order],
                    duration_s=0.0, all_energies=energies)
        result.duration_s = whole.seconds
        return result


def _demo(model_dir: Optional[str] = None, device=None) -> GraspResult:
    """The JAX package's pipeline demo: a 48x64 synthetic scene of two
    spheres seen from one camera, a tiny `GraspEBM` (32-wide ViT at 32^2,
    32 features, 2 blocks of 32, 3 5-d poses) with seeded weights, those
    that `model_dir`'s `model_final` files hold replaced by theirs, 64
    guesses and 4 ascent steps; prints the top-k energies and poses."""
    from ..data.generators import camera_parameters
    from ..data.synthetic import SyntheticScene, generate_views
    from ..params import init_params

    dev = resolve_device(device)
    h, w = 48, 64
    scene = SyntheticScene.random(0, n_spheres=2)
    colors, configs = generate_views(scene, 2, height=h, width=w,
                                     radius=1.0, polar=0.6)
    images = np.asarray(colors[0][..., :3] / 255.0, np.float32)[None, None]
    ext_inv, k4 = camera_parameters(configs[0])
    intr = np.asarray(k4, np.float32)[None, None]
    ext = np.asarray(ext_inv, np.float32)[None, None]
    model = GraspEBM(n_views=1, n_features=32, original_image_size=(h, w),
                     n_5d_poses=3, n_blocks=2, hidden_size=32,
                     vit_size=(32, 32), vit_patch=16, vit_dim=32, vit_heads=2,
                     vit_hooks=(1, 2, 3, 4)).to(dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    workspace = ((0.3, 0.7), (-0.25, 0.25), (0.0, 0.3))
    if model_dir:
        pipe = GraspPipeline.from_checkpoints(model, model_dir, workspace,
                                              n_initial_guesses=64,
                                              n_optimization_steps=4)
    else:
        pipe = GraspPipeline(model=model, params=None,
                             workspace_bounds=workspace,
                             n_initial_guesses=64, n_optimization_steps=4)
    result = pipe.infer(images, intr, ext, rng=0)
    print(f"refined {len(result.all_energies)} guesses in "
          f"{result.duration_s:.2f}s; top-{len(result.poses)}:")
    for pose, score in zip(result.poses, result.scores):
        t = np.round(pose.translation, 3)
        print(f"  energy={score:+.4f} t={t} quat={np.round(pose.quat, 3)}")
    return result


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="grasp pipeline demo on a synthetic scene")
    parser.add_argument("model_dir", nargs="?", default=None,
                        help="a grasp run's directory (its model_final "
                             "files); seeded weights without it")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()
    _demo(args.model_dir, args.device)
