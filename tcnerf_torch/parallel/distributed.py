"""Multi-process support (tcnerf/parallel/distributed.py): the process
group, per-process input sharding and the global batch.

One process drives one device (a "rank"). Here:
  * `initialize()` forms the `torch.distributed` group when the run spans
    several processes (a no-op for one, as in JAX): NCCL on the card, gloo
    on the CPU, never one in place of the other;
  * `host_shard_indices(n)` gives this process its contiguous block of a
    dataset's indices, the JAX function's bits for the same process,
    process count and `rng`;
  * `global_batch_array` assembles the global batch from the ranks' local
    batches.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

# how long a rendezvous or a collective may wait for the other ranks
GROUP_TIMEOUT = timedelta(seconds=60)


def backend_for(device: torch.device) -> str:
    """The collective backend of a device type: NCCL for CUDA, gloo else."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Form the default process group when `num_processes` > 1; a no-op
    otherwise. coordinator_address: "host:port" of rank 0 (a TCP
    rendezvous), or None to read MASTER_ADDR / MASTER_PORT / RANK from the
    environment as `torchrun` sets them. device: the devices' type (the
    card unless the caller asks for the CPU). If NCCL cannot form the group
    the call raises."""
    if num_processes is None or num_processes <= 1:
        return
    dev = resolve_device(device)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend_for(dev), init_method=init,
                            world_size=num_processes,
                            rank=-1 if process_id is None else process_id,
                            timeout=GROUP_TIMEOUT)


def rank_and_world():
    """(this process's rank, the number of processes): (0, 1) without a
    group, as `jax.process_index` / `process_count` on one host."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard_indices(n_samples: int, rng=None) -> np.ndarray:
    """This process's sample indices (contiguous block partitioning), after
    an optional `np.random.default_rng(rng)` shuffle of all of them."""
    p, n_p = rank_and_world()
    per = -(-n_samples // n_p)
    idx = np.arange(n_samples)
    if rng is not None:
        np.random.default_rng(rng).shuffle(idx)
    return idx[p * per:(p + 1) * per]


def check_spans_world(mesh) -> None:
    """The port's meshes span the whole process group (make_mesh): its
    collectives run on the default group. Raises ValueError otherwise."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh's {mesh.size()} ranks are not the "
                         f"group's {dist.get_world_size()}")


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-shaped tensors concatenated along dim 0 in rank
    order, on every rank: one all-gather into a plain tensor."""
    out = x.new_empty((dist.get_world_size() * x.shape[0],) + x.shape[1:])
    # the name of the one-tensor all-gather differs between torch versions
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.contiguous())
    return out


def global_batch_array(local_batch, mesh) -> torch.Tensor:
    """The ranks' local batches (equal shapes; numpy or tensors) as one
    global batch on every rank, in rank order along dim 0, on the mesh's
    device type. The design is an all-gather into a plain tensor, not a
    `DTensor`: the port's kernels take plain tensors."""
    check_spans_world(mesh)
    x = (local_batch if isinstance(local_batch, torch.Tensor)
         else torch.as_tensor(np.asarray(local_batch)))
    return all_gather_rows(x.to(mesh.device_type))
