"""Fused serving-path renderer (tcnerf/models/fused.py), 1 view.

For one view the mid-network view fusion is the identity, so embedding and
readout form one dense chain:

  * `fused_field` / `fused_render_rays` run it through the resmlp kernel
    (ops/resmlp.py) after a 4-tap gather of the raw 259-channel image;
  * `swg_prepare` pre-projects the image through layer_0's feature rows
    once, and `swg_field` / `swg_render_chunk` run gather + geometry head +
    chain + readout as one fused kernel per stage (ops/swg.py).

The TPU path sorts each stage's queries into windows that can overflow; the
CUDA kernel gathers directly, so `n_overflow` is kept in the return values
for parity with the JAX API and is always 0. The TPU window knobs (ka, bq,
sg, msplit, patch_cap, nsplit) have no counterpart. The functions take the
port's `MVNeRFRenderer` in place of the flax parameter tree.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core import projection, render, sampling
from ..core.encoding import positional_encoding
from ..ops.interpolate import gather_projection_features
from ..ops.resmlp import ChainPack, resmlp_rows
from ..ops.sortmerge import merge_sorted, sort_small
from ..ops.swg import encode_head, pack_swg, swg_field_plain, swg_field_rows


def flatten_mv_params(embedding, readout=None) -> Tuple[torch.Tensor, ...]:
    """MVResNetMLPEmbedding (1 view) [+ RenderReadout] -> flat chain weights
    in the JAX layout ([in, out] kernels): layer_0, feature blocks, fusion
    blocks, readout."""
    layers = [embedding.layer_0]
    for blk in embedding.feature_blocks + embedding.fusion_blocks:
        layers += [blk.layer_0, blk.layer_1]
    if readout is not None:
        layers.append(readout.output_layer)
    flat = []
    for layer in layers:
        flat += [layer.weight.t(), layer.bias]
    return tuple(flat)


def _chroma_density(out: torch.Tensor, shape):
    out = out.float().reshape(shape + (4,))
    return torch.sigmoid(out[..., :3]), torch.nn.functional.softplus(out[..., 3])


def fused_field(flat_weights, world_points, cam_dirs, normalized_images,
                src_intrinsics, src_extrinsics_inv, combined_features,
                n_blocks: int, n_freq: int = 10,
                embed_direction_vector: bool = True,
                pos_encoding_freq: float = math.pi):
    """Chroma/density through the resmlp kernel (1 view)."""
    b, r, s, _ = world_points.shape
    pixel_xy, cam_points = projection.project_points_mv(
        world_points, src_intrinsics, src_extrinsics_inv)
    feats = gather_projection_features(normalized_images, combined_features,
                                       pixel_xy)          # [B, 1, R, S, C+3]
    dirs = cam_dirs[:, :, :, None, :].expand(b, 1, r, s, 3)
    x = torch.cat([
        positional_encoding(cam_points[..., :3], n_freq, pos_encoding_freq),
        (positional_encoding(dirs, n_freq, pos_encoding_freq)
         if embed_direction_vector else dirs),
        feats], dim=-1)
    x = x.reshape(-1, x.shape[-1]).to(combined_features.dtype).contiguous()
    out = resmlp_rows(x, flat_weights, n_blocks, readout=True)
    return _chroma_density(out, (b, r, s))


def fused_render_rays(model, ray_o, ray_d, src_images, src_intrinsics,
                      src_extrinsics_inv, combined_features,
                      n_samples: int = 64, near: float = 0.3, far: float = 1.3,
                      n_blocks: int = 6, u_coarse=None, u_fine=None,
                      generator: Optional[torch.Generator] = None):
    """Hierarchical render through `fused_field` (MVNeRFRenderer.render_rays
    semantics for one view)."""
    dtype = combined_features.dtype
    coarse = tuple(w.to(dtype) for w in flatten_mv_params(
        model.coarse_embedding, model.coarse_readout))
    fine = tuple(w.to(dtype) for w in flatten_mv_params(
        model.fine_embedding, model.fine_readout))
    normalized = (src_images * 2.0 - 1.0).to(dtype)
    world_points, z = sampling.sample_along_ray(
        ray_o, ray_d, near, far, n_samples, u_jitter=u_coarse,
        generator=generator)
    cam_dirs = projection.world_to_camera_directions_mv(ray_d,
                                                        src_extrinsics_inv)
    chroma, density = fused_field(coarse, world_points, cam_dirs, normalized,
                                  src_intrinsics, src_extrinsics_inv,
                                  combined_features, n_blocks)
    rgb, depth, weights = render.volumetric_render(z, density, chroma)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    z_fine = sampling.sample_pdf(z_mid, weights[..., 1:-1], n_samples,
                                 u_pdf=u_fine, generator=generator)
    all_z = merge_sorted(z, sort_small(z_fine))
    fine_points = ray_o[:, :, None, :] + all_z[..., None] * ray_d[:, :, None, :]
    fine_chroma, fine_density = fused_field(
        fine, fine_points, cam_dirs, normalized, src_intrinsics,
        src_extrinsics_inv, combined_features, n_blocks)
    fine_rgb, fine_depth, _ = render.volumetric_render(all_z, fine_density,
                                                       fine_chroma)
    return rgb, depth, fine_rgb, fine_depth


# ------------------------------------------------------------- fused swg path

class SwgStage(NamedTuple):
    head_k: torch.Tensor       # [pd, hidden] f32, rows [:pd] of layer_0
    head_b: torch.Tensor       # [hidden] f32
    flat: Tuple[torch.Tensor, ...]   # block + readout weights, stream dtype
    image: torch.Tensor        # [H, W, hidden] pre-projected, stream dtype
    pack: Optional[ChainPack]  # head + chain as the kernel reads it (CUDA)


class SwgPrepared(NamedTuple):
    coarse: SwgStage
    fine: SwgStage
    n_freq: int


def swg_stage_params(model, stage: str, n_blocks: int, dtype):
    """(head kernel, head bias, flat block + readout weights) of a stage."""
    emb = getattr(model, f"{stage}_embedding")
    flat = flatten_mv_params(emb, getattr(model, f"{stage}_readout"))
    k = emb.layer_0.weight.t()
    return k, emb.layer_0.bias, tuple(w.to(dtype).contiguous()
                                      for w in flat[2:])


def swg_prepare(model, src_images, combined_features, n_blocks: int = 6,
                pd: Optional[int] = None, dtype=None,
                n_freq: int = 10) -> SwgPrepared:
    """Every chunk-invariant artifact of the swg path, computed once: per
    stage the head split of layer_0, the chain weights in the stream dtype,
    the 259-channel image pre-projected through layer_0's feature rows and,
    on a card, the kernel's packed weights.
    dtype: stream dtype (default combined_features'); serving passes bf16."""
    if pd is None:
        pd = 12 * n_freq
    if pd != 12 * n_freq:
        raise ValueError(f"pd={pd} inconsistent with n_freq={n_freq}")
    b, v = src_images.shape[:2]
    if b != 1 or v != 1:
        raise ValueError("swg_prepare is the 1-view serving path")
    dtype = combined_features.dtype if dtype is None else dtype
    normalized = (src_images * 2.0 - 1.0).to(dtype)
    combined = torch.cat([normalized, combined_features.to(dtype)], -1)[0, 0]
    stages = []
    for stage in ("coarse", "fine"):
        k, b0, flat = swg_stage_params(model, stage, n_blocks, dtype)
        image = (combined @ k[pd:].to(dtype)).contiguous()
        pack = (pack_swg(flat, n_blocks, k[:pd].float(), b0.float(), n_freq)
                if image.is_cuda else None)
        stages.append(SwgStage(k[:pd].float(), b0.float(), flat, image, pack))
    return SwgPrepared(stages[0], stages[1], n_freq)


def swg_field(stage: SwgStage, world_points, cam_dirs, src_intrinsics,
              src_extrinsics_inv, n_blocks: int, n_freq: int = 10,
              fast: bool = True, plain: bool = False):
    """One field stage through the fused kernel: head inside for the bf16
    stream (`fast`), head given for the f32 stream. `plain` runs the plain
    PyTorch version instead (kernel checks). Returns (chroma, density,
    overflowed=False)."""
    b, r, s, _ = world_points.shape
    pixel_xy, cam_points = projection.project_points_mv(
        world_points, src_intrinsics, src_extrinsics_inv)
    coords = pixel_xy.reshape(-1, 2).contiguous()
    pos = cam_points[..., :3].reshape(-1, 3).contiguous()
    dirs = cam_dirs[:, :, :, None, :].expand(b, 1, r, s, 3).reshape(-1, 3) \
        .contiguous()
    field = (swg_field_plain if plain else
             functools.partial(swg_field_rows, pack=stage.pack))
    if fast:
        out = field(stage.image, coords, pos, dirs, stage.flat, n_blocks,
                    stage.head_k, stage.head_b, fast=True, n_freq=n_freq)
    else:
        h0 = encode_head(pos, dirs, stage.head_k, stage.head_b,
                         stage.image.dtype, n_freq)
        out = field(stage.image, coords, None, None, stage.flat, n_blocks,
                    h0_geo=h0, fast=False, n_freq=n_freq)
    chroma, density = _chroma_density(out, (b, r, s))
    return chroma, density, False


def swg_render_chunk(prepared: SwgPrepared, ray_o, ray_d, src_intrinsics,
                     src_extrinsics_inv, n_samples: int = 64,
                     near: float = 0.3, far: float = 1.3, n_blocks: int = 6,
                     fast: bool = True, u_coarse=None, u_fine=None,
                     generator: Optional[torch.Generator] = None,
                     plain: bool = False):
    """One hierarchical render chunk against `swg_prepare` artifacts.

    Returns (rgb, depth, fine_rgb, fine_depth, n_overflow=0)."""
    world_points, z = sampling.sample_along_ray(
        ray_o, ray_d, near, far, n_samples, u_jitter=u_coarse,
        generator=generator)
    cam_dirs = projection.world_to_camera_directions_mv(ray_d,
                                                        src_extrinsics_inv)
    kw = dict(n_freq=prepared.n_freq, fast=fast, plain=plain)
    chroma, density, _ = swg_field(prepared.coarse, world_points, cam_dirs,
                                   src_intrinsics, src_extrinsics_inv,
                                   n_blocks, **kw)
    rgb, depth, weights = render.volumetric_render(z, density, chroma)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    z_fine = sampling.sample_pdf(z_mid, weights[..., 1:-1], n_samples,
                                 u_pdf=u_fine, generator=generator)
    all_z = torch.sort(torch.cat([z, z_fine], dim=-1), dim=-1).values
    fine_points = ray_o[:, :, None, :] + all_z[..., None] * ray_d[:, :, None, :]
    fine_chroma, fine_density, _ = swg_field(
        prepared.fine, fine_points, cam_dirs, src_intrinsics,
        src_extrinsics_inv, n_blocks, **kw)
    fine_rgb, fine_depth, _ = render.volumetric_render(all_z, fine_density,
                                                       fine_chroma)
    return rgb, depth, fine_rgb, fine_depth, 0


def swg_render_rays(model, ray_o, ray_d, src_images, src_intrinsics,
                    src_extrinsics_inv, combined_features,
                    n_samples: int = 64, near: float = 0.3, far: float = 1.3,
                    n_blocks: int = 6, pd: int = 120, fast: bool = True,
                    dtype=None, u_coarse=None, u_fine=None,
                    generator: Optional[torch.Generator] = None):
    """Single-shot swg render (prepare + one chunk); chunk loops should call
    `swg_prepare` once and `swg_render_chunk` per chunk."""
    prepared = swg_prepare(model, src_images, combined_features,
                           n_blocks=n_blocks, pd=pd, dtype=dtype)
    return swg_render_chunk(prepared, ray_o, ray_d, src_intrinsics,
                            src_extrinsics_inv, n_samples=n_samples,
                            near=near, far=far, n_blocks=n_blocks, fast=fast,
                            u_coarse=u_coarse, u_fine=u_fine,
                            generator=generator)
