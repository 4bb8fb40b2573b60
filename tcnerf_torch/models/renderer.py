"""Multi-view pixel-conditioned NeRF renderer (tcnerf/models/renderer.py).

`field="pixel"` with every fusion: "without" (the visual features
upsampled 2x) and "v0".."v4" (the frozen CLIP RN50 tower on the
preprocessed sources, fused by CombineCLIPVisualV0..V4; v3/v4 gate on a
text embedding, a ones placeholder unless the caller passes one), and
`corner_gather` True (pre-projected corner-row gather) or False (4-tap
gather). The constructor keeps the flax module's argument names so configs
map one to one.

`field="hashgrid"` is the per-scene fast field (nn/hashgrid_field.py): the
model holds only the coarse and fine `HashGridField` (the `hashgrid_*`
knobs) and their `RenderReadout`s, so its state dict is the flax tree's;
`combine_features` runs no tower and returns an empty [n, 1, 1, 0] feature
map with a zero aux, and `render_rays` conditions the colour on the
world-frame ray directions, with no corner image and no projection.

Sampling draws: `render_rays` takes the coarse jitter and the PDF uniforms
as optional explicit tensors (`u_coarse` [B, R, S], `u_fine` [B, R, S]);
otherwise it draws them from `generator`.

`combine_features` names its parts as spans (`utils/profiling.py`, ranges
under the profiler): "tcnerf.encode" (ViT/DPT + conv encoder),
"tcnerf.clip" (preprocess and the CLIP tower), "tcnerf.combine" (the
fusion, or the 2x upsample).

`remat` checkpoints the two embeddings and `VisualFeatures` while autograd
records (torch.utils.checkpoint): their activations are recomputed in the
backward instead of stored, as the flax module's `nn.remat` does. Neither
draws random numbers, so the recompute sees the forward's values.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import projection, render, sampling
from ..clip.model import CLIPVisualEncoder
from ..clip.preprocess import preprocess
from ..nn.blocks import RenderReadout
from ..nn.fusion import FUSIONS
from ..nn.hashgrid_field import HashGridField
from ..nn.layers import resize_bilinear
from ..nn.mlp import MVResNetMLPEmbedding
from ..nn.vit import VisualFeatures
from ..ops.interpolate import (bilinear_gather_corners,
                               gather_projection_features, make_corner_image)
from ..ops.sortmerge import merge_sorted, sort_small
from ..utils.profiling import span

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(d):
    return _DTYPES[d] if d is None or isinstance(d, str) else d


class MVNeRFRenderer(nn.Module):
    def __init__(self, n_views: int = 2, n_samples: int = 64,
                 n_features: int = 256, embed_direction_vector: bool = True,
                 near: float = 0.7, far: float = 1.5,
                 original_image_size: Tuple[int, int] = (480, 640),
                 fusion: str = "v0", n_blocks: int = 6, hidden_size: int = 128,
                 vit_size: Tuple[int, int] = (224, 224), vit_patch: int = 16,
                 vit_dim: int = 768, vit_heads: int = 12,
                 vit_hooks: Sequence[int] = (3, 6, 9, 12),
                 clip_layers: Sequence[int] = (3, 4, 6, 3),
                 clip_width: int = 64, clip_embed_dim: int = 1024,
                 clip_image_size: int = 224, field: str = "pixel",
                 hashgrid_levels: int = 16, hashgrid_table_log2: int = 14,
                 hashgrid_hidden: int = 64, hashgrid_layers: int = 3,
                 hashgrid_bounds=((-0.2, 1.2), (-0.8, 0.8), (-0.4, 1.0)),
                 fusion_use_dense: bool = False,
                 fusion_activation: str = "relu", corner_gather: bool = True,
                 pallas_mlp: bool = False, remat: bool = False,
                 encoder_dtype: Optional[str] = None, dtype=None):
        super().__init__()
        if field not in ("pixel", "hashgrid"):
            raise ValueError(f"unknown field {field!r}")
        if fusion != "without" and fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}")
        self.n_views = n_views
        self.n_samples = n_samples
        self.n_features = n_features
        self.embed_direction_vector = embed_direction_vector
        self.near, self.far = near, far
        self.original_image_size = tuple(original_image_size)
        self.fusion = fusion
        self.fusion_use_dense = fusion_use_dense
        self.fusion_activation = fusion_activation
        self.field = field
        self.n_blocks = n_blocks
        self.hidden_size = hidden_size
        self.corner_gather = corner_gather
        self.pallas_mlp = pallas_mlp
        self.remat = remat
        self.dtype = _dtype(dtype)
        self.encoder_dtype = _dtype(encoder_dtype)
        self.clip_image_size = clip_image_size
        self.clip_embed_dim = clip_embed_dim
        if field == "hashgrid":
            fld = dict(n_levels=hashgrid_levels,
                       table_size_log2=hashgrid_table_log2,
                       bounds=hashgrid_bounds, hidden_size=hashgrid_hidden,
                       n_layers=hashgrid_layers, dtype=self.dtype)
            self.coarse_embedding = HashGridField(**fld)
            self.coarse_readout = RenderReadout(hashgrid_hidden, 4,
                                                dtype=self.dtype)
            self.fine_embedding = HashGridField(**fld)
            self.fine_readout = RenderReadout(hashgrid_hidden, 4,
                                              dtype=self.dtype)
            return
        kw = dict(n_input_features=n_features + 3, n_blocks=n_blocks,
                  hidden_size=hidden_size, n_views=n_views,
                  embed_direction_vector=embed_direction_vector,
                  use_pallas=pallas_mlp, dtype=self.dtype)
        self.coarse_embedding = MVResNetMLPEmbedding(**kw)
        self.coarse_readout = RenderReadout(hidden_size, 4, dtype=self.dtype)
        self.fine_embedding = MVResNetMLPEmbedding(**kw)
        self.fine_readout = RenderReadout(hidden_size, 4, dtype=self.dtype)
        self.visual_features = VisualFeatures(
            n_features=n_features, original_image_size=original_image_size,
            vit_size=vit_size, patch_size=vit_patch, embed_dim=vit_dim,
            num_heads=vit_heads, hooks=vit_hooks,
            dtype=self.encoder_dtype or self.dtype)
        if fusion != "without":
            self.clip_visual = CLIPVisualEncoder(
                layers=tuple(clip_layers), width=clip_width,
                output_dim=clip_embed_dim, heads=max(clip_width // 2, 1),
                image_size=clip_image_size, dtype=self.dtype)
            clip_channels = tuple(clip_width * 4 * 2 ** i for i in range(4))
            if fusion in ("v3", "v4"):
                self.combine_clip_visual = FUSIONS[fusion](
                    clip_channels, n_features, clip_embed_dim,
                    use_dense=fusion_use_dense, activation=fusion_activation,
                    dtype=self.dtype)
            else:
                self.combine_clip_visual = FUSIONS[fusion](
                    clip_channels, n_features, dtype=self.dtype)

    # ------------------------------------------------------------ features

    def _remat(self, module, *args):
        """module(*args), checkpointed under `remat` while autograd records."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def encode(self, src_images_flat: torch.Tensor) -> torch.Tensor:
        """[B*V, H, W, 3] -> visual features [B*V, H/2, W/2, n_features]."""
        out = self._remat(self.visual_features, src_images_flat)
        if self.encoder_dtype is not None:
            out = out.to(self.dtype or torch.float32)
        return out

    def combine_features(self, src_images_flat: torch.Tensor,
                         clip_outputs=None, clip_textuals=None):
        """Full fused feature image [B*V, H, W, n_features] and the aux loss.

        'without': the visual features upsampled 2x, aux 0. v0..v4: the
        fusion of `clip_outputs` (the CLIP tower's 5-tuple; computed from
        the preprocessed sources, without autograd, when None) with the
        visual features, gated by `clip_textuals` [B*V, clip_embed_dim]
        (ones when None, the NeRF trainers' placeholder). The hash-grid
        field: an empty [B*V, 1, 1, 0] map and aux 0, no tower."""
        if self.field == "hashgrid":
            n = src_images_flat.shape[0]
            empty = src_images_flat.new_zeros((n, 1, 1, 0))
            return empty, src_images_flat.new_zeros(())
        with span("tcnerf.encode"):
            vis = self.encode(src_images_flat)
        if self.fusion == "without":
            with span("tcnerf.combine"):
                n, h, w, _ = vis.shape
                up = resize_bilinear(vis, (h * 2, w * 2))
            return up, torch.zeros((), dtype=up.dtype, device=up.device)
        if clip_outputs is None:
            # the frozen tower without autograd: its parameters take no
            # update and its input is no parameter, so no gradient of the
            # step goes through it (the JAX optimizer's `set_to_zero`)
            with span("tcnerf.clip"), torch.no_grad():
                clip_outputs = self.clip_visual(
                    preprocess(src_images_flat, self.clip_image_size))
        if clip_textuals is None:
            clip_textuals = torch.ones(
                (src_images_flat.shape[0], self.clip_embed_dim),
                dtype=vis.dtype, device=vis.device)
        with span("tcnerf.combine"):
            return self.combine_clip_visual(clip_outputs, vis, clip_textuals)

    # ----------------------------------------------------------- rendering

    def render_rays(self, ray_origins, ray_directions, src_images,
                    src_intrinsics, src_extrinsics_inv, combined_features,
                    u_coarse: Optional[torch.Tensor] = None,
                    u_fine: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """Hierarchical render of a ray batch.

        ray_origins/directions [B, R, 3]; src_images [B, V, H, W, 3];
        intrinsics/extrinsics_inv [B, V, 4, 4]; combined_features
        [B, V, H, W, C]. Returns (rgb, depth, fine_rgb, fine_depth)."""
        hashgrid = self.field == "hashgrid"
        normalized = None if hashgrid else (
            src_images * 2.0 - 1.0).to(combined_features.dtype)
        corner_c = corner_f = None
        if self.corner_gather and not hashgrid:
            combined = torch.cat([normalized, combined_features], dim=-1)
            flat_img = combined.reshape((-1,) + combined.shape[2:])
            corner_c = make_corner_image(
                self.coarse_embedding.project_image(flat_img))
            corner_f = make_corner_image(
                self.fine_embedding.project_image(flat_img))

        world_points, z = sampling.sample_along_ray(
            ray_origins, ray_directions, self.near, self.far, self.n_samples,
            u_jitter=u_coarse, generator=generator)
        if hashgrid:
            # the per-scene field reads the world-frame ray direction
            cam_dirs = ray_directions[:, None]                 # [B, 1, R, 3]
        else:
            cam_dirs = projection.world_to_camera_directions_mv(
                ray_directions, src_extrinsics_inv)
        chroma, density = self._field(
            world_points, cam_dirs, normalized, src_intrinsics,
            src_extrinsics_inv, combined_features, self.coarse_embedding,
            self.coarse_readout, corner_img=corner_c)
        rgb, depth, weights = render.volumetric_render(z, density, chroma)

        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_fine = sampling.sample_pdf(z_mid, weights[..., 1:-1],
                                     self.n_samples, u_pdf=u_fine,
                                     generator=generator)
        all_z = merge_sorted(z, sort_small(z_fine))
        fine_points = (ray_origins[:, :, None, :]
                       + all_z[..., None] * ray_directions[:, :, None, :])
        fine_chroma, fine_density = self._field(
            fine_points, cam_dirs, normalized, src_intrinsics,
            src_extrinsics_inv, combined_features, self.fine_embedding,
            self.fine_readout, corner_img=corner_f)
        fine_rgb, fine_depth, _ = render.volumetric_render(
            all_z, fine_density, fine_chroma)
        return rgb, depth, fine_rgb, fine_depth

    def _field(self, world_points, cam_dirs, normalized_images,
               src_intrinsics, src_extrinsics_inv, combined_features,
               embedding, readout, corner_img=None):
        b, r, s, _ = world_points.shape
        if self.field == "hashgrid":
            dirs = cam_dirs[:, 0, :, None, :].expand(b, r, s, 3)
            return readout(embedding(world_points, dirs))
        v = normalized_images.shape[1]
        pixel_xy, cam_points = projection.project_points_mv(
            world_points, src_intrinsics, src_extrinsics_inv)
        if corner_img is not None:
            feats = bilinear_gather_corners(
                corner_img, pixel_xy.reshape(b * v, r * s, 2))
            feats = feats.reshape(b, v, r, s, feats.shape[-1])
        else:
            feats = gather_projection_features(
                normalized_images, combined_features, pixel_xy)
        dirs = cam_dirs[:, :, :, None, :].expand(b, v, r, s, 3)

        def flat(x):
            return x.reshape((b * v, r, s, x.shape[-1]))

        emb = self._remat(embedding, flat(cam_points[..., :3]), flat(dirs),
                          flat(feats), corner_img is not None)
        return readout(emb)

    def forward(self, inputs, u_coarse=None, u_fine=None, generator=None,
                clip_outputs=None, clip_textuals=None):
        """Encode + fuse features, then render. inputs = (ray_origins,
        ray_directions, src_images, src_intrinsics, src_extrinsics_inv).
        Returns (rgb, depth, fine_rgb, fine_depth, aux)."""
        ray_o, ray_d, src_images, src_intr, src_ext_inv = inputs
        b, v = src_images.shape[:2]
        combined, aux = self.combine_features(
            src_images.reshape((b * v,) + src_images.shape[2:]),
            clip_outputs, clip_textuals)
        combined = combined.reshape((b, v) + combined.shape[1:])
        out = self.render_rays(ray_o, ray_d, src_images, src_intr,
                               src_ext_inv, combined, u_coarse, u_fine,
                               generator)
        return out + (aux,)
