"""NeRF training step and optimizer (tcnerf/models/training.py).

The optimizer is the JAX package's `optax.multi_transform` over parameter
groups, chosen by top-level module:
  * 'nerf' (lr 1e-4): embeddings, readouts, the fusion decoder;
  * 'feature' (lr 1e-5): the ViT + conv visual encoder;
  * 'frozen': the CLIP towers (no update; none exist for fusion "without").
Each trained group clips every gradient element to +-grad_clip, then runs
Adam (b1 0.9, b2 0.999, eps 1e-8) at the warmup schedule's rate. optax
evaluates the schedule at the update count *before* the update, so the
first update has learning rate 0; `NerfOptimizer` does the same.

`nerf_train_step` draws every sample uniform up front and hands each ray
chunk its slice, so a checkpointed chunk recomputes with the draws of its
forward (a draw inside the chunk would give the recompute new samples and
the gradient would be silently wrong). A step is the span
"tcnerf.train.step" (`utils/profiling.py`), its parts "tcnerf.train.forward"
(the draws and the loss), "tcnerf.train.backward" and "tcnerf.train.update".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..opt.schedules import warmup_constant_schedule
from ..utils.profiling import span

FEATURE_COMPONENTS = ("visual_features",)
FROZEN_COMPONENTS = ("clip_visual", "clip_textual")


def param_group(name: str) -> str:
    """'nerf', 'feature' or 'frozen' for a parameter name, by its top-level
    module (every module that is neither feature nor frozen is nerf)."""
    top = name.split(".", 1)[0]
    if top in FROZEN_COMPONENTS:
        return "frozen"
    if top in FEATURE_COMPONENTS:
        return "feature"
    return "nerf"


class NerfOptimizer:
    """Per group: element-wise clip to +-grad_clip, then Adam with the
    group's warmup schedule; the frozen group is never updated. A parameter
    without a gradient is updated with a zero gradient, as optax does."""

    def __init__(self, model: nn.Module, nerf_lr: float = 1e-4,
                 feature_lr: float = 1e-5, warmup_steps: int = 10000,
                 scale_down_after: int = 450000, grad_clip: float = 1.0):
        groups: Dict[str, list] = {"nerf": [], "feature": [], "frozen": []}
        for name, p in model.named_parameters():
            groups[param_group(name)].append(p)
        lrs = {"nerf": nerf_lr, "feature": feature_lr}
        self.schedules = {g: warmup_constant_schedule(lr, warmup_steps,
                                                      scale_down_after)
                          for g, lr in lrs.items()}
        self.all_params = list(model.parameters())
        self.grad_clip = grad_clip
        self.count = 0
        self.adam = torch.optim.Adam(
            [{"params": groups[g], "group": g} for g in lrs if groups[g]],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        for p in self.all_params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.schedules[group["group"]](self.count)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.clamp_(-self.grad_clip, self.grad_clip)
        self.adam.step()
        self.count += 1


def make_nerf_optimizer(model: nn.Module, nerf_lr: float = 1e-4,
                        feature_lr: float = 1e-5, warmup_steps: int = 10000,
                        scale_down_after: int = 450000,
                        grad_clip: float = 1.0) -> NerfOptimizer:
    return NerfOptimizer(model, nerf_lr, feature_lr, warmup_steps,
                         scale_down_after, grad_clip)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: NerfOptimizer

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in `.grad`."""
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module,
                       optimizer: Optional[NerfOptimizer] = None
                       ) -> TrainState:
    """The model's parameters are initialised by the caller
    (`params.init_params` or `load_state_dict`)."""
    return TrainState(0, model, optimizer or make_nerf_optimizer(model))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.mean(torch.square(pred - target))
                               + 1e-12)


def draw_samples(model: nn.Module, b: int, r: int,
                 generator: Optional[torch.Generator], device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stratified jitter and the PDF uniforms of a [B, R] ray batch, in
    render_rays' order: (u_coarse, u_fine), each [B, R, n_samples]."""
    shape = (b, r, model.n_samples)
    return (torch.rand(shape, generator=generator, device=device),
            torch.rand(shape, generator=generator, device=device))


def nerf_loss(model: nn.Module, inputs, labels: torch.Tensor,
              u_coarse: torch.Tensor, u_fine: torch.Tensor,
              ray_chunk: Optional[int] = None) -> torch.Tensor:
    """MSE(coarse) + MSE(fine) + aux. With a ray chunk the encoder runs once
    and each chunk renders under torch.utils.checkpoint; the loss is the
    mean of the equal chunks' losses, the same value. `ray_chunk` None
    chunks at 128 rays once the batch holds >= 2048 rays, so that the
    backward holds one chunk's activations at a time."""
    ray_o, ray_d, src_images, src_intr, src_ext = inputs
    b, r = ray_o.shape[:2]
    v = src_images.shape[1]
    if ray_chunk is None and b * r >= 2048 and r % 128 == 0:
        ray_chunk = 128
    if not ray_chunk or r <= ray_chunk or r % ray_chunk != 0:
        rgb, _, fine_rgb, _, aux = model(inputs, u_coarse, u_fine)
        return mse(labels, rgb) + mse(labels, fine_rgb) + aux

    combined, aux = model.combine_features(
        src_images.reshape((b * v,) + src_images.shape[2:]))
    combined = combined.reshape((b, v) + combined.shape[1:])

    def chunk_loss(ro, rd, combined, lab, u_c, u_f):
        rgb, _, fine_rgb, _ = model.render_rays(
            ro, rd, src_images, src_intr, src_ext, combined, u_coarse=u_c,
            u_fine=u_f)
        return mse(lab, rgb) + mse(lab, fine_rgb)

    n_chunks = r // ray_chunk
    total = 0.0
    for c in range(n_chunks):
        sl = slice(c * ray_chunk, (c + 1) * ray_chunk)
        total = total + checkpoint(
            chunk_loss, ray_o[:, sl], ray_d[:, sl], combined, labels[:, sl],
            u_coarse[:, sl], u_fine[:, sl], use_reentrant=False)
    return total / n_chunks + aux


@span("tcnerf.train.step")
def nerf_train_step(state: TrainState, inputs, labels: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    ray_chunk: Optional[int] = None,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One optimisation step: loss = MSE(coarse) + MSE(fine) (+ aux).

    inputs = (ray_o [B, R, 3], ray_d, src_images [B, V, H, W, 3],
    intrinsics [B, V, 4, 4], extrinsics_inv) and labels [B, R, 3] on the
    model's device; the samples' uniforms are `draws` (u_coarse, u_fine)
    or drawn from `generator`.
    Returns (state, {"loss": loss before the update, a device scalar})."""
    model = state.model
    with span("tcnerf.train.forward"):
        if draws is None:
            b, r = inputs[0].shape[:2]
            draws = draw_samples(model, b, r, generator, inputs[0].device)
        state.optimizer.zero_grad()
        loss = nerf_loss(model, inputs, labels, *draws, ray_chunk=ray_chunk)
    with span("tcnerf.train.backward"):
        loss.backward()
    with span("tcnerf.train.update"):
        state.apply_gradients()
    return state, {"loss": loss.detach()}
