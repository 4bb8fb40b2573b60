"""Multi-device full-image rendering: the serving-side scaling path
(tcnerf/parallel/serve.py).

Training shards rays per step (mesh.py / explicit.py); this module shards
a FULL-IMAGE render over the whole mesh: the image's ray chunks are split
across every rank (both mesh axes flattened: an image render has no batch
dimension, so 'data' and 'ray' both act as ray-parallel here), each rank
runs its contiguous block of chunks through the renderer's `render_rays`
(the flax-shaped path; with `pallas_mlp` its chain halves launch K1 on the
card), and one all-gather of equal-sized buffers brings the slices back to
every rank. Features are encoded once by the caller and replicated.

Chunk i always renders with chunk i's draws: `draws[i]`, or the i-th
(coarse, fine) pair of the generator's stream consumed exactly as
`models.inference.render_all_rays` consumes it, which every rank replays
in chunk order. So the rank count does not change the image, and on one
rank it is `render_all_rays`'s image.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.inference import Draws, _assemble, _ray_chunks
from ..utils.profiling import span
from .distributed import all_gather_rows, check_spans_world


def render_image_sharded(mesh: DeviceMesh, model, src_images, src_intrinsics,
                         src_extrinsics_inv, combined_features, tgt_pose,
                         tgt_intrinsics3, height: int, width: int,
                         chunk: int = 512, draws: Optional[Draws] = None,
                         generator: Optional[torch.Generator] = None):
    """Render the full target view with ray chunks sharded over the mesh.

    The rays are padded to a whole number of chunks per rank (origin 0,
    direction 1), so the chunk count depends on the rank count; `draws`
    (per chunk (u_coarse, u_fine) [1, chunk, S]) must cover it. Without
    `draws` the samples come from `generator` (None: the default
    generator). Returns (fine_rgb [H, W, 3], fine_depth [H, W]) on every
    rank."""
    check_spans_world(mesh)
    world = mesh.size()
    chunks_o, chunks_d, n = _ray_chunks(tgt_pose, tgt_intrinsics3, height,
                                        width, chunk, n_parts=world)
    per_rank = chunks_o.shape[0] // world
    first = dist.get_rank() * per_rank
    shape = (1, chunk, model.n_samples)
    rgbs, depths = [], []
    with span("tcnerf.chunks"):
        for i in range(chunks_o.shape[0]):
            if draws is not None:
                u_c, u_f = draws[i]
            else:          # render_rays' two draws for the chunk, in order
                u_c, u_f = (torch.rand(shape, generator=generator,
                                       dtype=chunks_o.dtype,
                                       device=chunks_o.device)
                            for _ in range(2))
            if not first <= i < first + per_rank:
                continue
            _, _, fine_rgb, fine_depth = model.render_rays(
                chunks_o[i], chunks_d[i], src_images, src_intrinsics,
                src_extrinsics_inv, combined_features, u_coarse=u_c,
                u_fine=u_f)
            rgbs.append(fine_rgb[0])
            depths.append(fine_depth[0])
    rgb = torch.cat(rgbs)                               # [per_rank * chunk, 3]
    depth = torch.cat(depths)
    both = torch.promote_types(rgb.dtype, depth.dtype)   # exact for each
    whole = all_gather_rows(torch.cat([rgb.to(both), depth[:, None].to(both)],
                                      dim=1))
    return _assemble([whole[:, :3].to(rgb.dtype)],
                     [whole[:, 3].to(depth.dtype)], n, height, width)
