"""Full-image rendering (tcnerf/models/inference.py).

Features are encoded once, then the target view's rays run through a
Python loop over ray chunks: on the fused swg path (the serving default on
the card; always the bf16 stream) or on the flax-shaped `render_rays` path.
Rays padding the last chunk get origin 0 and direction 1. Spans
(`utils/profiling.py`, ranges under the profiler): `render_view` is
"tcnerf.view", its host inputs and uploads "tcnerf.view.inputs", the rays
"tcnerf.view.rays", the chunk loop "tcnerf.chunks" (the swg path's weight
packing "tcnerf.swg_prepare"; the encoder's spans are the renderer's), the
chunks' assembly into the image "tcnerf.view.assemble" and its copy to the
host "tcnerf.view.readback". The helpers `_ray_chunks` and `_assemble`,
which the sharded render shares, carry no span of their own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.rays import get_rays
from ..data.generators import camera_parameters
from ..device import resolve_device
from ..utils.profiling import span
from .fused import swg_prepare, swg_render_chunk

Draws = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _ray_chunks(tgt_pose, tgt_intrinsics3, height: int, width: int,
                chunk: int, n_parts: int = 1):
    """The target's rays as [n_chunks, 1, chunk, 3] origins and directions,
    padded to a whole number of chunks for each of `n_parts` devices
    (parallel/serve.py), and the count of real rays."""
    rays_o, rays_d = get_rays(width, height, tgt_pose, tgt_intrinsics3)
    n = height * width
    n_pad = -(-n // (n_parts * chunk)) * chunk * n_parts - n
    dev = rays_o.device
    flat_o = torch.cat([rays_o.reshape(-1, 3),
                        torch.zeros((n_pad, 3), device=dev)])
    flat_d = torch.cat([rays_d.reshape(-1, 3),
                        torch.ones((n_pad, 3), device=dev)])
    n_chunks = (n + n_pad) // chunk
    return (flat_o.reshape(n_chunks, 1, chunk, 3),
            flat_d.reshape(n_chunks, 1, chunk, 3), n)


def _assemble(rgbs, depths, n: int, height: int, width: int):
    fine_rgb = torch.cat([c.reshape(-1, 3) for c in rgbs])[:n]
    fine_depth = torch.cat([c.reshape(-1) for c in depths])[:n]
    return (fine_rgb.reshape(height, width, 3),
            fine_depth.reshape(height, width))


def render_all_rays(model, src_images, src_intrinsics, src_extrinsics_inv,
                    combined_features, tgt_pose, tgt_intrinsics3,
                    height: int, width: int, chunk: int,
                    draws: Optional[Draws] = None,
                    generator: Optional[torch.Generator] = None):
    """All target rays through `model.render_rays`, chunk by chunk.
    draws: optional per-chunk (u_coarse, u_fine). Returns float
    (fine_rgb [H, W, 3], fine_depth [H, W])."""
    with span("tcnerf.view.rays"):
        chunks_o, chunks_d, n = _ray_chunks(tgt_pose, tgt_intrinsics3,
                                            height, width, chunk)
    rgbs, depths = [], []
    with span("tcnerf.chunks"):
        for i in range(chunks_o.shape[0]):
            u_c, u_f = draws[i] if draws is not None else (None, None)
            _, _, fine_rgb, fine_depth = model.render_rays(
                chunks_o[i], chunks_d[i], src_images, src_intrinsics,
                src_extrinsics_inv, combined_features, u_coarse=u_c,
                u_fine=u_f, generator=generator)
            rgbs.append(fine_rgb[0])
            depths.append(fine_depth[0])
    with span("tcnerf.view.assemble"):
        return _assemble(rgbs, depths, n, height, width)


def render_all_rays_swg(model, src_images, src_intrinsics, src_extrinsics_inv,
                        combined_features, tgt_pose, tgt_intrinsics3,
                        height: int, width: int, chunk: int,
                        draws: Optional[Draws] = None,
                        generator: Optional[torch.Generator] = None):
    """All target rays through the fused swg path (1 view), bf16 stream
    whatever the model dtype. Returns (fine_rgb, fine_depth, n_overflow=0)."""
    with span("tcnerf.view.rays"):
        chunks_o, chunks_d, n = _ray_chunks(tgt_pose, tgt_intrinsics3,
                                            height, width, chunk)
    with span("tcnerf.swg_prepare"):
        prepared = swg_prepare(model, src_images, combined_features,
                               n_blocks=model.n_blocks, dtype=torch.bfloat16)
    rgbs, depths = [], []
    with span("tcnerf.chunks"):
        for i in range(chunks_o.shape[0]):
            u_c, u_f = draws[i] if draws is not None else (None, None)
            _, _, fine_rgb, fine_depth, _ = swg_render_chunk(
                prepared, chunks_o[i], chunks_d[i], src_intrinsics,
                src_extrinsics_inv, n_samples=model.n_samples,
                near=model.near, far=model.far, n_blocks=model.n_blocks,
                u_coarse=u_c, u_fine=u_f, generator=generator)
            rgbs.append(fine_rgb[0])
            depths.append(fine_depth[0])
    with span("tcnerf.view.assemble"):
        return _assemble(rgbs, depths, n, height, width) + (0,)


def swg_default(model, n_views: int, device: torch.device) -> bool:
    """render_view's default path: the fused swg path for the 1-view,
    hidden-128, direction-encoded pixel-field model on the card."""
    return (model.field == "pixel" and n_views == 1
            and model.hidden_size == 128 and model.embed_direction_vector
            and device.type == "cuda")


@span("tcnerf.view")
def render_view(model, src_colors, src_camera_configs, tgt_camera_config,
                generator: Optional[torch.Generator] = None,
                chunk: Optional[int] = None, clip_outputs=None,
                clip_textuals=None, use_swg: Optional[bool] = None,
                device=None):
    """Render the target camera's full view from source images.

    src_colors: list of [H, W, >=3] uint8; camera configs are
    {'pose': 4x4, 'intrinsics': 9-flat}. Returns (rgb uint8 [H, W, 3],
    min-max-normalised depth uint8 [H, W, 1]). `model` must live on
    `device` (default cuda). use_swg: the fused swg path; default
    `swg_default`. A hash-grid model (`field="hashgrid"`) takes the plain
    path and raises ValueError on use_swg=True: the swg kernels compute
    the pixel field (the JAX default would send a hidden-128 hash-grid
    model on a TPU to the swg kernel; ROADMAP Queue C). chunk:
    rays per chunk, default 8192 on the swg path and 512 otherwise.
    clip_outputs / clip_textuals go to `combine_features` (a CLIP-fused
    model computes the first from the sources and gates on ones when they
    are None)."""
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, render on {dev}")
    h, w = src_colors[0].shape[:2]
    with span("tcnerf.view.inputs"):
        src = np.array([c[..., :3] / 255.0 for c in src_colors],
                       dtype=np.float32)[None]             # [1, V, H, W, 3]
        cams = [camera_parameters(cfg) for cfg in src_camera_configs]
        src_ext = torch.as_tensor(
            np.asarray([c[0] for c in cams], np.float32)[None], device=dev)
        src_intr = torch.as_tensor(
            np.asarray([c[1] for c in cams], np.float32)[None], device=dev)
        src_images = torch.as_tensor(src, device=dev)
        tgt_pose = torch.as_tensor(
            np.asarray(tgt_camera_config["pose"], np.float32), device=dev)
        tgt_intr3 = torch.as_tensor(np.reshape(
            tgt_camera_config["intrinsics"], (3, 3)).astype(np.float32),
            device=dev)
    v = src.shape[1]
    if use_swg and model.field == "hashgrid":
        raise ValueError("render_view: the swg path computes the pixel "
                         "field; a hash-grid model renders on the plain path")
    if use_swg is None:
        use_swg = swg_default(model, v, dev)
    with torch.inference_mode():
        combined, _ = model.combine_features(src_images[0], clip_outputs,
                                             clip_textuals)
        combined = combined[None]
        args = (model, src_images, src_intr, src_ext, combined, tgt_pose,
                tgt_intr3, h, w)
        if use_swg:
            fine_rgb, fine_depth, _ = render_all_rays_swg(
                *args, 8192 if chunk is None else chunk, generator=generator)
        else:
            fine_rgb, fine_depth = render_all_rays(
                *args, 512 if chunk is None else chunk, generator=generator)
        with span("tcnerf.view.readback"):
            rgb = np.clip(fine_rgb.float().cpu().numpy() * 255, 0, 255
                          ).astype(np.uint8)
            depth = fine_depth.float().cpu().numpy()[..., None]
            denom = max(depth.max() - depth.min(), 1e-12)
            depth_u8 = ((depth - depth.min()) / denom * 255).astype(np.uint8)
    return rgb, depth_u8


def psnr(pred_u8: np.ndarray, target_u8: np.ndarray) -> float:
    """PSNR between uint8 images (dB)."""
    a = pred_u8.astype(np.float64) / 255.0
    b = target_u8.astype(np.float64) / 255.0
    mse = float(np.mean((a - b) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))
