"""Explicit data/ray-parallel steps with hand-placed collectives
(tcnerf/parallel/explicit.py).

JAX's module writes the per-shard loss and gradient as a `shard_map` body
with a `pmean` over ('data', 'ray'). In the port every collective is
explicit anyway: the train step here is `mesh.reduced_step` (one all-reduce
of the gradients and the loss over the whole mesh) fed by each shard's own
sample stream, and the ascent step has no collective at all.

Layout (mesh axes from tcnerf_torch.parallel.mesh.make_mesh):
  * 'data': batch dimension of every input;
  * 'ray': the ray axis of (ray_o, ray_d, labels);
  * params / optimizer state: replicated; gradients averaged over both axes.

The source images (and so the encoder forward) are replicated over 'ray':
with ray > 1 each ray shard recomputes the feature towers, the right trade
for rendering (features are O(1) per step, rays O(n)).

As in JAX, the shard's model sees only the shard's block: its
batch-statistics norms normalise with the statistics of the block's
B / data images (JAX applies the model inside `shard_map` with no axis
name). So with data > 1 the explicit step is not the sharded step
(`mesh.nerf_train_step_sharded`, whose statistics are the global batch's),
even on the same draws; with data = 1 it is.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.training import TrainState, draw_samples
from .distributed import all_gather_rows, check_spans_world
from .mesh import IMAGE_SPEC, RAY_SPEC, pose_shardings, reduced_step


def nerf_in_specs():
    """The layout of `mesh.nerf_batch_shardings` as data: per input (ray_o,
    ray_d, src_images, src_intrinsics, src_ext_inv), then the labels, the
    mesh axes of each dim."""
    return (RAY_SPEC, RAY_SPEC, IMAGE_SPEC, IMAGE_SPEC, IMAGE_SPEC), RAY_SPEC


def _shard_generator(seed: int, mesh: DeviceMesh,
                    device: torch.device) -> torch.Generator:
    """A generator of this shard's own stream, seeded from `seed` and the
    rank's (data, ray) coordinates: the counterpart of JAX's `fold_in` of
    the mesh position (the port does not replay JAX's stream)."""
    word = np.random.SeedSequence([seed, *mesh.get_coordinate()]
                                  ).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word) >> 1)


def make_explicit_train_step(mesh: DeviceMesh):
    """step(state, local_inputs, local_labels, seed=0, draws=None) ->
    (state, {"loss"}): the loss and gradients of this rank's block, with
    the block's batch statistics and its own samples
    (`_shard_generator(seed)`, or this rank's draws, (u_coarse, u_fine)
    [B / data, R / ray, S]), averaged over the whole mesh, then one update
    of the replicated state. On a mesh with data = 1 and each rank's block
    of the global draws it is `mesh.nerf_train_step_sharded`."""

    def step(state: TrainState, inputs, labels, seed: int = 0, draws=None):
        if draws is None:
            b, r = inputs[0].shape[:2]
            dev = inputs[0].device
            draws = draw_samples(state.model, b, r,
                                 _shard_generator(seed, mesh, dev), dev)
        return reduced_step(state, inputs, labels, draws)

    return step


def make_explicit_ascent_step(mesh: DeviceMesh, energy_fn: Callable):
    """Pose-optimization gradients with the guess axis sharded over the
    mesh. energy_fn(t, r, *args) -> per-guess energies. The returned
    grads(t, r, *args) takes the global guesses t [1, N, 3], r [1, N, 4|6]
    and returns dE/d(t, r) of -sum(energy_fn) on this rank's block of them
    (`pose_shardings`); guesses are independent, so there is no collective
    (`gather_guesses` reads back the whole). Call it under
    `opt.pose_optimizer.frozen(model)` to keep the model's parameters out
    of autograd, as the optimizer does."""
    sharding = pose_shardings(mesh)

    def grads(t, r, *args):
        t = sharding.local(t).detach().requires_grad_(True)
        r = sharding.local(r).detach().requires_grad_(True)
        with torch.enable_grad():
            total = -energy_fn(t, r, *args).sum()
            return torch.autograd.grad(total, (t, r))

    return grads


def gather_guesses(x: torch.Tensor, mesh: DeviceMesh, dim: int = 1
                   ) -> torch.Tensor:
    """The ranks' blocks of the guess axis (`dim` of x) concatenated in mesh
    order: [1, N / n, ...] -> [1, N, ...] on every rank. The mesh spans
    the whole group (make_mesh)."""
    check_spans_world(mesh)
    whole = all_gather_rows(x.detach().movedim(dim, 0))
    return whole.movedim(0, dim)
