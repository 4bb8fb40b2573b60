"""Device mesh and sharding layout for multi-device training and inference
(tcnerf/parallel/mesh.py).

  * mesh axes ('data', 'ray'): batch-level data parallelism over 'data',
    ray/pose-level parallelism over 'ray' (this workload's "sequence" axis:
    rays x samples for rendering, guesses x probes for pose optimization);
    one rank (process) per device, laid out row-major;
  * parameters and optimizer state are replicated (`shard_params`
    broadcasts rank 0's); each rank holds its block of the batch
    (`Sharding.local`, the counterpart of `device_put` with a
    `NamedSharding`);
  * where JAX's jit inserts the gradient reduction from the shardings,
    `nerf_train_step_sharded` places it by hand: one all-reduce of the
    flattened gradients and the loss, SUM then a division by the world size
    (gloo has no AVG), which with equal shards is JAX's mean.

`make_mesh(1)` works in a bare process: it forms a world-1 group on an
in-process store (no port is opened), which `destroy_mesh` tears down.
"""

from __future__ import annotations

import functools
import math
from contextlib import contextmanager
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..models.training import TrainState, draw_samples, nerf_loss
from ..nn.norm import BatchStatNorm
from .distributed import GROUP_TIMEOUT, backend_for, check_spans_world

MESH_AXES = ("data", "ray")
# per tensor dim: the mesh axes it is split over (None: replicated)
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]
RAY_SPEC: Spec = ("data", "ray")        # [B, R, ...]: batch and ray axes
IMAGE_SPEC: Spec = ("data",)            # [B, V, ...]: the batch axis only
GUESS_SPEC: Spec = (None, MESH_AXES)    # [1, N, ...]: N over the whole mesh


def make_mesh(n_devices: Optional[int] = None,
              data_axis: Optional[int] = None, device=None) -> DeviceMesh:
    """Mesh over the group's ranks, factored as (data, ray); rank r sits at
    (r // ray, r % ray). data_axis: size of the data-parallel axis
    (default all ranks, ray=1). Without a process group `n_devices` must be
    None or 1 and a world-1 group is formed (NCCL on the card, gloo on the
    CPU). device: the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":       # the communicator's device, before the group
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}): no process group; "
                             "launch one process per device (torchrun, "
                             "parallel.dryrun) and call initialize first")
        dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=GROUP_TIMEOUT)
    if backend_for(dev) not in dist.get_backend():
        raise ValueError(f"the process group's backend is "
                         f"{dist.get_backend()}, not {backend_for(dev)} for "
                         f"{dev.type}")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh({n}): the group has {world} ranks")
    data_axis = n if data_axis is None else data_axis
    if n % data_axis:
        raise ValueError(f"{n} ranks do not factor with data axis "
                         f"{data_axis}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(data_axis, -1),
                      mesh_dim_names=MESH_AXES)


def destroy_mesh() -> None:
    """Tear down the default process group (and the mesh's groups)."""
    if dist.is_initialized():
        dist.destroy_process_group()


class Sharding(NamedTuple):
    """`NamedSharding(mesh, spec)`: `spec[d]` names the mesh axes tensor dim
    d is split over; `local(x)` is this rank's block of the global x."""
    mesh: DeviceMesh
    spec: Spec

    def local(self, x) -> torch.Tensor:
        """This rank's contiguous block of x (numpy or a tensor) on the
        mesh's device. Raises ValueError on unequal shards."""
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        index = [slice(None)] * len(x.shape)
        for d, axes in enumerate(self.spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else axes
            n = math.prod(sizes[a] for a in axes)
            i = 0
            for a in axes:                       # row-major over the axes
                i = i * sizes[a] + coord[a]
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of shape {tuple(x.shape)} does "
                                 f"not split into {n} equal shards")
            per = x.shape[d] // n
            index[d] = slice(i * per, (i + 1) * per)
        block = x[tuple(index)]
        if isinstance(block, np.ndarray):
            block = torch.as_tensor(np.ascontiguousarray(block))
        return block.to(self.mesh.device_type).contiguous()


def _coalesced(tensors: Sequence[torch.Tensor], device, collective) -> None:
    """Run `collective` on one flat buffer per dtype of `tensors` (on
    `device`) and copy the result back into them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            with torch.no_grad():
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def shard_params(model: torch.nn.Module, optimizer, mesh: DeviceMesh):
    """Replicate rank 0's parameters, buffers and optimizer state (Adam's
    moments and counts, `NerfOptimizer.count`; None for none) on every
    rank of the mesh. The ranks' optimizers must have the same state
    layout. Returns (model, optimizer)."""
    check_spans_world(mesh)
    device = next(model.parameters()).device
    tensors = list(model.parameters()) + list(model.buffers())
    if optimizer is not None:
        adam = getattr(optimizer, "adam", optimizer)
        for group in adam.param_groups:
            for p in group["params"]:
                state = adam.state.get(p, {})
                tensors += [state[k] for k in sorted(state)
                            if isinstance(state[k], torch.Tensor)]
        if hasattr(optimizer, "count"):
            count = torch.tensor([optimizer.count], device=device)
            tensors.append(count)
    _coalesced(tensors, device, lambda flat: dist.broadcast(flat, 0))
    if optimizer is not None and hasattr(optimizer, "count"):
        optimizer.count = int(count)
    return model, optimizer


def nerf_batch_shardings(mesh: DeviceMesh):
    """Shardings of the renderer batch (ray_o, ray_d, src_images,
    src_intrinsics, src_ext_inv) and of the labels: the batch dim over
    'data'; the ray axis of the ray tensors and labels over 'ray'."""
    ray, img = Sharding(mesh, RAY_SPEC), Sharding(mesh, IMAGE_SPEC)
    return (ray, ray, img, img, img), ray


def shard_nerf_batch(inputs, labels, mesh: DeviceMesh):
    """This rank's block of the global batch (inputs, labels)."""
    in_shardings, label_sharding = nerf_batch_shardings(mesh)
    inputs = tuple(s.local(x) for x, s in zip(inputs, in_shardings))
    return inputs, label_sharding.local(labels)


def pose_shardings(mesh: DeviceMesh) -> Sharding:
    """Pose-optimizer sharding: the guess axis N over the full mesh (both
    axes flattened), images replicated."""
    return Sharding(mesh, GUESS_SPEC)


def shard_guesses(x, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's contiguous block of the guess axis of x [1, N, ...]."""
    return pose_shardings(mesh).local(x)


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group's ranks; its gradient is the SUM of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def _synced_norm_forward(norm: BatchStatNorm, group, x: torch.Tensor
                         ) -> torch.Tensor:
    """BatchStatNorm.forward with the statistics of the batch of every rank
    of `group` together (differentiable all-reduces of the sums)."""
    axes = norm.reduction_axes or tuple(range(x.dim() - 1))
    n = math.prod(x.shape[a] for a in axes) * dist.get_world_size(group)
    mean = _AllReduceSum.apply(x.sum(dim=axes, keepdim=True), group) / n
    var = _AllReduceSum.apply(
        torch.square(x - mean).sum(dim=axes, keepdim=True), group) / n
    y = (x - mean) * torch.rsqrt(var + norm.epsilon)
    return y * norm.scale + norm.bias


@contextmanager
def synced_batch_stats(model: torch.nn.Module, mesh: DeviceMesh):
    """The model's batch-statistics norms (the convolutional encoder's)
    normalise with the statistics of the whole 'data' axis for the block's
    duration, forward and backward (a rematerialised encoder recomputes
    them in the backward): the statistics one process takes over the
    global batch. Ranks along 'ray' hold the same images, so 'ray' needs
    no reduction. The norms' own forward is restored on leaving."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    norms = ([m for m in model.modules() if isinstance(m, BatchStatNorm)]
             if sizes["data"] > 1 else [])
    group = mesh.get_group("data") if norms else None
    for m in norms:
        m.forward = functools.partial(_synced_norm_forward, m, group)
    try:
        yield
    finally:
        for m in norms:
            del m.forward


def reduced_step(state: TrainState, inputs, labels, draws):
    """The local loss and its gradients on this rank's block, the gradients
    and the loss all-reduced to their mean over every rank, then one
    optimizer update on every rank. Returns (state, {"loss": the mean loss
    before the update})."""
    optimizer = state.optimizer
    optimizer.zero_grad()
    loss = nerf_loss(state.model, inputs, labels, *draws)
    loss.backward()
    params = [p for g in optimizer.adam.param_groups for p in g["params"]]
    for p in params:   # a missing gradient is zero (NerfOptimizer's rule);
        if p.grad is None:          # every rank's buffer has one layout
            p.grad = torch.zeros_like(p)
    loss = loss.detach().reshape(1)
    world = dist.get_world_size()

    def mean(flat):
        dist.all_reduce(flat)            # SUM: gloo has no ReduceOp.AVG
        flat.div_(world)

    _coalesced([p.grad for p in params] + [loss], loss.device, mean)
    state.apply_gradients()
    return state, {"loss": loss[0]}


def nerf_train_step_sharded(state: TrainState, local_inputs, local_labels,
                            mesh: DeviceMesh,
                            generator: Optional[torch.Generator] = None,
                            draws=None):
    """`models.training.nerf_train_step` on a sharded batch, with the
    replicated state (the counterpart of JAX's step on sharded arrays).
    Every rank draws the global [B, R, S] uniforms from the same
    `generator` (or takes the global `draws`, (u_coarse, u_fine)) and uses
    its block; the batch statistics are those of the global batch
    (`synced_batch_stats`). So the step equals the one-process step on the
    global batch with the same generator."""
    if draws is None:
        b, r = local_inputs[0].shape[:2]
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        draws = draw_samples(state.model, b * sizes["data"], r * sizes["ray"],
                             generator, local_inputs[0].device)
    ray = Sharding(mesh, RAY_SPEC)
    with synced_batch_stats(state.model, mesh):
        return reduced_step(state, local_inputs, local_labels,
                            tuple(ray.local(u) for u in draws))
