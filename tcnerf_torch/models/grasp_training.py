"""Training steps of the grasp energy (tcnerf/models/grasp_training.py).

* `grasp_train_step`, the goal EBM: a landscape loss over each sample's
  poses (cross-entropy on the energies as logits, or KL divergence after a
  softmax), differentiated into the trainable components.
* `delta_ngf_train_step`, the delta-NGF and language fields: the same
  landscape loss plus gradient supervision. The energy's gradient with
  respect to the pose parameters along trajectory windows is matched to the
  expert's steps by cosine losses, and the total backpropagates through that
  inner gradient (second order) into the trainable components.

The features are encoded once without autograd; only the trainable
components (`GraspTrainState.trainable`, by default the readout alone) have
`requires_grad`, so the frozen backbone and CLIP towers never get a
backward pass. The optimizer is optax's `chain(clip(1.0), adam(lr))`: each
gradient entry clamped to +-1, then Adam (b1 0.9, b2 0.999, eps 1e-8) with
optax's arithmetic (`opt/pose_optimizer.py` `adam_direction`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

from ..core.bounds import clip
from ..opt.pose_optimizer import AdamState, adam_direction
from .grasp import GraspEBM, Prepared


def categorical_crossentropy_logits(labels, logits):
    """keras CategoricalCrossentropy(from_logits=True), mean over the
    batch."""
    log_p = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels * log_p, dim=-1))


def kl_divergence(labels, probs, eps: float = 1e-7, reduction: str = "mean"):
    """keras KLDivergence: per sample sum(y_true * log(y_true / y_pred)),
    both clipped to [eps, 1]; the mean over the batch, or with
    `reduction="sum"` the sum."""
    y_true = torch.clamp(labels, eps, 1.0)
    y_pred = clip(probs, eps, 1.0)
    per_sample = torch.sum(y_true * torch.log(y_true / y_pred), dim=-1)
    return per_sample.sum() if reduction == "sum" else per_sample.mean()


def cosine_similarity_loss(y_true, y_pred, eps: float = 1e-12):
    """keras CosineSimilarity loss: minus the mean cosine similarity along
    the last axis."""
    t = y_true / clip(torch.linalg.norm(y_true, dim=-1, keepdim=True), eps)
    p = y_pred / clip(torch.linalg.norm(y_pred, dim=-1, keepdim=True), eps)
    return -torch.mean(torch.sum(t * p, dim=-1))


def landscape_loss_fn(loss_name: str, reduction: str = "mean"):
    """(loss(labels, energies_or_probs), whether a softmax comes first)."""
    if loss_name == "cross_entropy":
        return categorical_crossentropy_logits, False
    if loss_name == "kl_divergence":
        return functools.partial(kl_divergence, reduction=reduction), True
    raise ValueError(f"Loss {loss_name} not supported.")


class GraspOptimizer:
    """optax.chain(clip(grad_clip), adam(learning_rate)) over `params`."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 learning_rate: float = 1e-4, grad_clip: float = 1.0):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        self.states = [AdamState.zeros_like(p.detach()) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for i, (p, g) in enumerate(zip(self.params, grads)):
            direction, self.states[i] = adam_direction(
                torch.clamp(g, -self.grad_clip, self.grad_clip),
                self.states[i])
            p.add_(direction * -self.learning_rate)


def make_grasp_optimizer(params, learning_rate: float = 1e-4,
                         grad_clip: float = 1.0) -> GraspOptimizer:
    return GraspOptimizer(params, learning_rate, grad_clip)


@dataclass
class GraspTrainState:
    """The model, the names of its trainable top-level components (the
    readout; `combine_clip_visual` too when the fusion decoder trains), the
    optimizer over their parameters and the step count."""
    model: GraspEBM
    optimizer: GraspOptimizer
    trainable: Tuple[str, ...] = ("grasp_readout",)
    step: int = 0
    names: List[str] = field(default_factory=list)

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return self.optimizer.params


def create_grasp_train_state(model: GraspEBM, learning_rate: float = 1e-4,
                             trainable=("grasp_readout",)) -> GraspTrainState:
    """Every parameter outside the `trainable` components stops requiring
    a gradient; the optimizer takes the rest."""
    trainable = tuple(trainable)
    names, params = [], []
    for name, p in model.named_parameters():
        on = name.split(".", 1)[0] in trainable
        p.requires_grad_(on)
        if on:
            names.append(name)
            params.append(p)
    missing = set(trainable) - {n.split(".", 1)[0] for n in names}
    if missing:
        raise ValueError(f"the model has no component {sorted(missing)}")
    return GraspTrainState(model, make_grasp_optimizer(params, learning_rate),
                           trainable, 0, names)


def _gradients(state: GraspTrainState, loss: torch.Tensor):
    """d loss / d(trainable parameters); zeros for one the loss does not
    reach, as JAX gives."""
    grads = torch.autograd.grad(loss, state.params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(state.params, grads)]


def _prepare(model: GraspEBM, src_images, features) -> Prepared:
    """`GraspEBM.prepare`, with autograd only where something upstream of
    the corner image trains (the fusion decoder's features, or the
    embedding)."""
    needs = torch.is_grad_enabled() and (
        features.requires_grad
        or any(p.requires_grad for p in model.fine_embedding.parameters()))
    with torch.set_grad_enabled(needs):
        return model.prepare(src_images, features)


def grasp_gradients(state: GraspTrainState, inputs, labels,
                    loss_name: str = "cross_entropy",
                    loss_reduction: str = "mean"):
    """The goal step's loss and its gradients, before clipping. inputs =
    [poses [B, N, 4, 4], src_images [B, V, H, W, 3], intrinsics,
    extrinsics_inv], labels = one-hot [B, N]. Returns ({"loss"}, grads)."""
    poses, src_images, src_intr, src_ext = inputs
    model = state.model
    loss_fn, softmax_before = landscape_loss_fn(loss_name, loss_reduction)
    with torch.no_grad():
        features = model.encode(src_images)
    with torch.enable_grad():
        prepared = _prepare(model, src_images, features)
        energies = model.energy_prepared(poses, prepared, src_intr, src_ext)
        if softmax_before:
            energies = torch.softmax(energies, dim=-1)
        loss = loss_fn(labels, energies)
        grads = _gradients(state, loss)
    return {"loss": loss.detach()}, grads


def grasp_train_step(state: GraspTrainState, inputs, labels,
                     loss_name: str = "cross_entropy",
                     loss_reduction: str = "mean"):
    """One goal-EBM step (`grasp_gradients`, then clip and Adam). Returns
    (state, {"loss": the loss before the update, a device scalar})."""
    metrics, grads = grasp_gradients(state, inputs, labels, loss_name,
                                     loss_reduction)
    state.optimizer.step(grads)
    state.step += 1
    return state, metrics


def delta_ngf_gradients(state: GraspTrainState, inputs, labels,
                        loss_name: str = "cross_entropy",
                        rotation_representation: str = "quaternion",
                        use_tokens: bool = False):
    """The delta-NGF step's metrics and gradients, before clipping.

    inputs = [l_t, l_r, g_t, g_r, src_images, intrinsics, extrinsics_inv
    (, clip tokens)], labels = [landscape one-hot, delta_t, delta_r]. The
    loss is the landscape loss of the (l_t, l_r) energies plus the cosine
    losses between the energy's gradient at (g_t, g_r) and the deltas (for
    6d rotations one per 3-column half). Under a trainable
    `combine_clip_visual` the frozen towers run outside autograd and the
    decoder inside. Returns ({"landscape_loss", "grad_loss_t",
    "grad_loss_r", "pred"}, grads)."""
    l_t, l_r, g_t, g_r, src_images, src_intr, src_ext = inputs[:7]
    clip_tokens = inputs[7] if use_tokens else None
    model = state.model
    loss_fn, softmax_before = landscape_loss_fn(loss_name)
    train_fusion = "combine_clip_visual" in state.trainable
    with torch.no_grad():
        if train_fusion:
            fusion_in = model.fusion_inputs(src_images, clip_tokens)
        else:
            features = model.compute_features(src_images, clip_tokens)
    with torch.enable_grad():
        if train_fusion:
            features = model.apply_fusion(*fusion_in)
        prepared = _prepare(model, src_images, features)

        def energy(t, r):
            return model.energy_from_pose_params_prepared(
                t, r, prepared, src_intr, src_ext, rotation_representation)

        y_pred = energy(l_t, l_r)
        if softmax_before:
            y_pred = torch.softmax(y_pred, dim=-1)
        landscape = loss_fn(labels[0], y_pred)

        t = g_t.detach().requires_grad_()
        r = g_r.detach().requires_grad_()
        prediction = energy(t, r)
        grad_t, grad_r = torch.autograd.grad(prediction.sum(), (t, r),
                                             create_graph=True)
        loss_t = cosine_similarity_loss(labels[1], grad_t)
        if rotation_representation == "quaternion":
            loss_r = cosine_similarity_loss(labels[2], grad_r)
        else:
            loss_r = (cosine_similarity_loss(labels[2][..., :3],
                                             grad_r[..., :3])
                      + cosine_similarity_loss(labels[2][..., 3:],
                                               grad_r[..., 3:]))
        grads = _gradients(state, loss_t + loss_r + landscape)
    metrics: Dict[str, torch.Tensor] = {
        "landscape_loss": landscape.detach(), "grad_loss_t": loss_t.detach(),
        "grad_loss_r": loss_r.detach(), "pred": prediction.detach().mean()}
    return metrics, grads


def delta_ngf_train_step(state: GraspTrainState, inputs, labels,
                         loss_name: str = "cross_entropy",
                         rotation_representation: str = "quaternion",
                         use_tokens: bool = False):
    """One delta-NGF step (`delta_ngf_gradients`, then clip and Adam).
    Returns (state, metrics)."""
    metrics, grads = delta_ngf_gradients(state, inputs, labels, loss_name,
                                         rotation_representation, use_tokens)
    state.optimizer.step(grads)
    state.step += 1
    return state, metrics
