"""The stage-1 NeRF of the reference, fusion "without", and what the
benchmark asks of it: a full view and a training loss.

Hierarchical sampling as published: 64 jittered bins over [near, far), the
coarse field, alpha compositing (the last distance repeated, +1e-10 in the
transmittance), inverse-CDF resampling of 64 more depths from the coarse
weights (+1e-5, the compare-count inversion, the `denom < 1e-5` guard), the
fine field over all 128 sorted depths. Each source's features are the
visual features upsampled 2x, gathered bilinearly with the normalised image
at every sample's projection.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from .encoder import VisualFeatures, full_resolution
from .field import Embedding, RenderReadout, directions_to_cameras, project
from .layers import bilinear_gather


class Renderer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        kw = (c["n_features"] + 3, c["n_blocks"], c["hidden"], c["n_views"])
        self.coarse_embedding = Embedding(*kw)
        self.coarse_readout = RenderReadout(c["hidden"])
        self.fine_embedding = Embedding(*kw)
        self.fine_readout = RenderReadout(c["hidden"])
        self.visual_features = VisualFeatures(c)

    def features(self, images_flat: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] in [0, 1] -> [N, H, W, C] full-resolution features."""
        return full_resolution(self.visual_features(images_flat))

    def field(self, stage: str, points, cam_dirs, images, intrinsics,
              extrinsics_inv, features):
        """points [B, R, S, 3]; cam_dirs [B, V, R, 3]; images / features
        [B, V, H, W, *] -> (rgb [B, R, S, 3], density [B, R, S])."""
        b, r, s, _ = points.shape
        v = images.shape[1]
        xy, cam = project(points, intrinsics, extrinsics_inv)
        combined = torch.cat([images * 2.0 - 1.0, features], -1)
        flat = combined.reshape((b * v,) + combined.shape[2:])
        feats = bilinear_gather(flat, xy.reshape(b * v, r * s, 2))
        dirs = cam_dirs[:, :, :, None, :].expand(b, v, r, s, 3)
        acts = getattr(self, f"{stage}_embedding")(
            cam.reshape(b * v, r, s, 3), dirs.reshape(b * v, r, s, 3),
            feats.reshape(b * v, r, s, -1))
        return getattr(self, f"{stage}_readout")(acts[-1])

    def render_rays(self, o, d, images, intrinsics, extrinsics_inv, features,
                    u_coarse, u_fine):
        """Rays o, d [B, R, 3] -> (coarse rgb, coarse depth, fine rgb, fine
        depth)."""
        c = self.c
        near, far, n = c["near"], c["far"], c["n_samples"]
        step = (far - near) / n
        z = near + step * torch.arange(n, dtype=o.dtype, device=o.device) \
            + u_coarse * step
        cam_dirs = directions_to_cameras(d, extrinsics_inv)
        pts = o[:, :, None] + z[..., None] * d[:, :, None]
        rgb_c, sigma_c = self.field("coarse", pts, cam_dirs, images,
                                    intrinsics, extrinsics_inv, features)
        rgb, depth, weights = composite(z, sigma_c, rgb_c)
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_fine = resample(z_mid, weights[..., 1:-1], u_fine)
        all_z = torch.sort(torch.cat([z, z_fine], -1), -1).values
        pts = o[:, :, None] + all_z[..., None] * d[:, :, None]
        rgb_f, sigma_f = self.field("fine", pts, cam_dirs, images, intrinsics,
                                    extrinsics_inv, features)
        fine_rgb, fine_depth, _ = composite(all_z, sigma_f, rgb_f)
        return rgb, depth, fine_rgb, fine_depth


def composite(z, sigma, rgb):
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, dists[..., -1:]], -1)
    alpha = 1.0 - torch.exp(-dists * torch.relu(sigma))
    keep = 1.0 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones_like(keep[..., :1]),
                                     keep[..., :-1]], -1), -1)
    w = alpha * trans
    return (w[..., None] * rgb).sum(-2), (w * z).sum(-1), w


def resample(bins, weights, u):
    """Inverse-CDF draws of u.shape[-1] depths from the piecewise PDF of
    `weights` over the bin centres `bins`."""
    w = weights + 1e-5
    total = w.sum(-1, keepdim=True)
    total = torch.where(total == 0, torch.ones_like(total), total)
    cdf = torch.cumsum(w / total, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    above = (u[..., :, None] >= cdf[..., None, :]).long().sum(-1)
    nb = bins.shape[-1]
    below = (above - 1).clamp(0, nb - 1)
    cdf_a = torch.gather(cdf, -1, above.clamp(0, cdf.shape[-1] - 1))
    cdf_b = torch.gather(cdf, -1, below)
    bins_a = torch.gather(bins, -1, above.clamp(0, nb - 1))
    bins_b = torch.gather(bins, -1, below)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


# ------------------------------------------------------------------ views

def camera_rays(pose: np.ndarray, k3: np.ndarray, h: int, w: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pixel's ray, row-major: ([H * W, 3] origins, directions):
    pose @ K^-1 @ (u, v, 1), normalised; K^-1 inverted in float32."""
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)
    k_inv = torch.linalg.inv(torch.as_tensor(np.asarray(k3, np.float32),
                                             device=device))
    rot = torch.as_tensor(np.asarray(pose, np.float32)[:3, :3], device=device)
    d = pix @ (rot @ k_inv).t()
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.as_tensor(np.asarray(pose, np.float32)[:3, 3],
                        device=device).expand_as(d)
    return o, d


def view_draws(n_rays: int, chunk: int, n_samples: int,
               generator: torch.Generator, device):
    """The uniforms a chunked view draws, in its order: per chunk of
    `chunk` rays (the last padded) the coarse jitter, then the PDF's
    uniforms. Returns ([n_rays, S], [n_rays, S])."""
    n_chunks = -(-n_rays // chunk)
    coarse, fine = [], []
    for _ in range(n_chunks):
        coarse.append(torch.rand((1, chunk, n_samples), generator=generator,
                                 device=device))
        fine.append(torch.rand((1, chunk, n_samples), generator=generator,
                               device=device))
    return (torch.cat(coarse, 1)[0, :n_rays], torch.cat(fine, 1)[0, :n_rays])


@torch.no_grad()
def render_view(model: Renderer, src_u8: np.ndarray, src_cam: dict,
                tgt_cam: dict, generator: torch.Generator, chunk: int,
                rays_per_block: int = 4096):
    """The target camera's view from one uint8 source image: (rgb uint8
    [H, W, 3], depth uint8 [H, W, 1] min-max normalised), rendered in blocks
    of `rays_per_block` rays with the draws of a view chunked by `chunk`."""
    dev = next(model.parameters()).device
    h, w = src_u8.shape[:2]
    images = torch.as_tensor(np.asarray(src_u8[..., :3], np.float64) / 255.0,
                             dtype=torch.float32, device=dev)[None, None]
    k4 = np.eye(4)
    k4[:3, :3] = np.reshape(src_cam["intrinsics"], (3, 3))
    intr = torch.as_tensor(k4[None, None], dtype=torch.float32, device=dev)
    ext = torch.as_tensor(np.linalg.inv(src_cam["pose"])[None, None],
                          dtype=torch.float32, device=dev)
    feats = model.features(images[0])[None]
    o, d = camera_rays(tgt_cam["pose"], np.reshape(tgt_cam["intrinsics"],
                                                   (3, 3)), h, w, dev)
    u_c, u_f = view_draws(h * w, chunk, model.c["n_samples"], generator, dev)
    rgbs, depths = [], []
    for a in range(0, h * w, rays_per_block):
        sl = slice(a, a + rays_per_block)
        _, _, rgb, depth = model.render_rays(
            o[None, sl], d[None, sl], images, intr, ext, feats,
            u_c[None, sl], u_f[None, sl])
        rgbs.append(rgb[0])
        depths.append(depth[0])
    rgb = torch.cat(rgbs).reshape(h, w, 3).cpu().numpy()
    depth = torch.cat(depths).reshape(h, w, 1).cpu().numpy()
    rgb_u8 = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    span = max(depth.max() - depth.min(), 1e-12)
    depth_u8 = ((depth - depth.min()) / span * 255).astype(np.uint8)
    return rgb_u8, depth_u8


# --------------------------------------------------------------- training

def loss(model: Renderer, batch, u_coarse, u_fine) -> torch.Tensor:
    """MSE of the coarse and of the fine colour against the labels, for a
    batch ((o, d [B, R, 3], images [B, V, H, W, 3], K, extrinsics^-1),
    labels [B, R, 3]); the encoder sees all B x V images at once."""
    (o, d, images, intr, ext), labels = batch
    b, v = images.shape[:2]
    feats = model.features(images.reshape((b * v,) + images.shape[2:]))
    feats = feats.reshape((b, v) + feats.shape[1:])
    rgb, _, fine_rgb, _ = model.render_rays(o, d, images, intr, ext, feats,
                                            u_coarse, u_fine)
    return ((labels - rgb) ** 2).mean() + ((labels - fine_rgb) ** 2).mean()
