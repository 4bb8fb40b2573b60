"""Energy-based grasp model over SE(3) poses (tcnerf/models/grasp.py).

`GraspEBM` scores candidate gripper poses: each pose expands into a grid of
6 x n_5d_poses probe transforms, the probes' positions project into the
source views, the NeRF MLP (`fine_embedding`, all its activations) reads
the feature image there, and `GraspReadout` turns the fused-stream
activations into one energy per pose. The backbone (`visual_features`,
`fine_embedding`) is the stage-1 renderer's; the language variant (fusion
v0-v4) adds the frozen CLIP towers and the fusion decoder. The constructor
keeps the flax module's argument names.

The JAX package relies on XLA to hoist the pose-independent work out of
the ascent loop. Here it is explicit: `prepare` builds, once per scene, the
normalized images with the features and, under `corner_gather`, the corner
image of layer_0's feature slice ([B * V, H, W, 4 * hidden] f32, ~1.9 GB
for three 480x640 views); `energy_prepared` takes it. `energy` is the two
in a row, the JAX function.

On the card, `energy_prepared` runs the per-probe rows through the probe
chain kernel pair (`ops/probe.py`, `csrc/probe.cu`: the corner tap, the
encoding, the chain and the readout's per-probe part in one forward
kernel, and a backward kernel for d(pose) alone) when all of these hold
(`probe_kernel_engages`): the poses are CUDA float32, the scene has its
corner image (`corner_gather`), one view (`n_views == 1`: the kernel does
not split at the view mean), no hash-grid stream, the layers it reads are
f32 shapes it computes (`_probe_pack`), and neither those weights nor the
corner image would take a gradient (grad mode off, or none of them
requires grad: the pose ascent freezes the weights). So the ascent, the
final energies and the grasp trainers' validation ascents take the
kernels; every other call, the trainers' steps among them, takes the
plain path below, unchanged. `probe_chain_plain` is the kernels' plain
version.

`hash_encoding` adds the hash-grid stream: a top-level parameter
`hash_tables` [hash_levels, 2^hash_size_log2, hash_features] over
`workspace_bounds`, whose encoding of the probes' world positions
(`ops/hashgrid.py`, plain PyTorch, as JAX's jnp) goes to the readout as its
`extra` stream, cast to the activations' dtype. It is part of
`energy_prepared`, so the pose ascent and the delta-NGF step see it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..clip.model import CLIPTextualEncoder, CLIPVisualEncoder
from ..clip.preprocess import preprocess
from ..core import projection, se3
from ..nn.fusion import FUSIONS
from ..nn.grasp_readout import GraspReadout
from ..nn.layers import resize_bilinear
from ..nn.mlp import MVResNetMLPEmbedding
from ..nn.vit import VisualFeatures
from ..ops.hashgrid import HashGridConfig, hash_encode
from ..ops.interpolate import (bilinear_gather, bilinear_gather_corners,
                               make_corner_image)
from ..ops.probe import (ProbeWeights, pack_probe, probe_chain,
                         probe_fits, probe_grad_free, tap_slice)
from ..tasks.transform import Affine


def probe_transforms(n_5d_poses: int = 7) -> np.ndarray:
    """The 6 gripper-frame bases x n z-offsets probe grid -> [P, 4, 4]
    float32 (offsets x 0.02, y 0.015, z 0.0125; the side fingers rotated
    +-pi/2 about y; z-steps spanning +-(x_off - 0.005))."""
    base_x, base_y, base_z = 0.02, 0.015, 0.0125
    step = (base_x - 0.005) / ((n_5d_poses - 1) / 2)
    bases = [
        Affine(translation=[0, base_y, 0]),
        Affine(translation=[0, -base_y, 0]),
        Affine(translation=[-base_x, base_y, base_z],
               rotation=[0.0, np.pi / 2, 0.0]),
        Affine(translation=[base_x, base_y, base_z],
               rotation=[0.0, -np.pi / 2, 0.0]),
        Affine(translation=[-base_x, -base_y, base_z],
               rotation=[0.0, np.pi / 2, 0.0]),
        Affine(translation=[base_x, -base_y, base_z],
               rotation=[0.0, -np.pi / 2, 0.0]),
    ]
    half = int((n_5d_poses - 1) / 2)
    offsets = [Affine(translation=[0.0, 0.0, i * step])
               for i in range(-half, half + 1)]
    mats = [(b * t).matrix for b in bases for t in offsets]
    return np.asarray(mats, dtype=np.float32)


class Prepared(NamedTuple):
    """The pose-independent part of `energy` for one scene: `combined`, the
    normalized images with the features [B * V, H, W, C + 3], and `corner`,
    the corner image of its layer_0 projection (None without
    corner_gather)."""
    batch: int
    views: int
    combined: Optional[torch.Tensor]
    corner: Optional[torch.Tensor]


class GraspEBM(nn.Module):
    def __init__(self, n_views: int = 1, n_features: int = 256,
                 original_image_size: Tuple[int, int] = (480, 640),
                 n_5d_poses: int = 7, readout_activation: str = "relu",
                 readout_kernel_init: str = "glorot_uniform",
                 readout_use_bias: bool = True, n_blocks: int = 6,
                 hidden_size: int = 128, fusion: Optional[str] = None,
                 fusion_use_dense: bool = True,
                 fusion_activation: str = "elu",
                 clip_layers: Sequence[int] = (3, 4, 6, 3),
                 clip_width: int = 64, clip_embed_dim: int = 1024,
                 clip_text_width: int = 512, clip_text_layers: int = 12,
                 clip_image_size: int = 224,
                 vit_size: Tuple[int, int] = (224, 224), vit_patch: int = 16,
                 vit_dim: int = 768, vit_heads: int = 12,
                 vit_hooks: Sequence[int] = (3, 6, 9, 12),
                 corner_gather: bool = True, hash_encoding: bool = False,
                 hash_levels: int = 16, hash_size_log2: int = 14,
                 hash_features: int = 2, hash_base_res: int = 16,
                 hash_finest_res: int = 512,
                 workspace_bounds=((0.35, 0.85), (-0.25, 0.25), (0.0, 0.2)),
                 remat_fusion: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if fusion is not None and fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}")
        self.n_views = n_views
        self.n_features = n_features
        self.original_image_size = tuple(original_image_size)
        self.n_5d_poses = n_5d_poses
        self.n_blocks = n_blocks
        self.fusion = fusion
        self.corner_gather = corner_gather
        self.remat_fusion = remat_fusion
        self.clip_image_size = clip_image_size
        self.clip_embed_dim = clip_embed_dim
        self.fine_embedding = MVResNetMLPEmbedding(
            n_features + 3, n_blocks=n_blocks, hidden_size=hidden_size,
            n_views=n_views, embed_direction_vector=True,
            complete_output=True, dtype=dtype)
        self.visual_features = VisualFeatures(
            n_features=n_features, original_image_size=original_image_size,
            vit_size=vit_size, patch_size=vit_patch, embed_dim=vit_dim,
            num_heads=vit_heads, hooks=vit_hooks, dtype=dtype)
        self.hash_cfg = None
        if hash_encoding:
            self.hash_cfg = HashGridConfig(
                n_levels=hash_levels, table_size_log2=hash_size_log2,
                features_per_level=hash_features,
                base_resolution=hash_base_res,
                finest_resolution=hash_finest_res,
                bounds=tuple(tuple(float(v) for v in b)
                             for b in workspace_bounds))
            self.hash_tables = nn.Parameter(torch.empty(
                hash_levels, self.hash_cfg.table_size, hash_features))
        n_fused = n_blocks - n_blocks // 2 + 1
        self.grasp_readout = GraspReadout(
            hidden_size, n_fused, self.n_probes, use_bias=readout_use_bias,
            activation=readout_activation,
            kernel_initializer=readout_kernel_init,
            extra_features=self.hash_cfg.out_dim if hash_encoding else 0,
            dtype=dtype)
        if fusion is not None:
            self.clip_visual = CLIPVisualEncoder(
                layers=tuple(clip_layers), width=clip_width,
                output_dim=clip_embed_dim, heads=max(clip_width // 2, 1),
                image_size=clip_image_size, dtype=dtype)
            self.clip_textual = CLIPTextualEncoder(
                width=clip_text_width, n_layers=clip_text_layers,
                heads=max(clip_text_width // 64, 1),
                output_dim=clip_embed_dim, dtype=dtype)
            channels = tuple(clip_width * 4 * 2 ** i for i in range(4))
            if fusion in ("v3", "v4"):
                self.combine_clip_visual = FUSIONS[fusion](
                    channels, n_features, clip_embed_dim,
                    use_dense=fusion_use_dense, activation=fusion_activation,
                    dtype=dtype)
            else:
                self.combine_clip_visual = FUSIONS[fusion](
                    channels, n_features, dtype=dtype)
        self.register_buffer("probes", torch.as_tensor(
            probe_transforms(n_5d_poses)), persistent=False)
        self.register_buffer("z_dir", torch.tensor([0.0, 0.0, 1.0]),
                             persistent=False)

    @property
    def n_probes(self) -> int:
        return 6 * self.n_5d_poses

    # ------------------------------------------------------------ features

    def encode(self, src_images: torch.Tensor) -> torch.Tensor:
        """[B, V, H, W, 3] -> full-resolution features [B, V, H, W, C]: the
        visual features upsampled 2x (jax.image.resize bilinear)."""
        b, v = src_images.shape[:2]
        feats = self.visual_features(
            src_images.reshape((b * v,) + src_images.shape[2:]))
        n, h, w, c = feats.shape
        feats = resize_bilinear(feats, (h * 2, w * 2))
        return feats.reshape((b, v, h * 2, w * 2, c))

    def fusion_inputs(self, src_images: torch.Tensor,
                      clip_tokens: Optional[torch.Tensor] = None):
        """The frozen towers' outputs the fusion decoder takes: the CLIP
        pyramid of the preprocessed sources, the visual features and the
        text embedding (ones without tokens), one row per image. The CLIP
        towers run without autograd: they are frozen."""
        b, v = src_images.shape[:2]
        flat = src_images.reshape((b * v,) + src_images.shape[2:])
        with torch.no_grad():
            clip_outputs = self.clip_visual(
                preprocess(flat, self.clip_image_size))
        vis = self.visual_features(flat)
        if clip_tokens is None:
            textuals = torch.ones((b * v, self.clip_embed_dim),
                                  dtype=vis.dtype, device=vis.device)
        else:
            with torch.no_grad():
                textuals = self.clip_textual(clip_tokens)
            textuals = torch.repeat_interleave(textuals, v, dim=0)
        return clip_outputs, vis, textuals

    def apply_fusion(self, clip_outputs, vis, textuals) -> torch.Tensor:
        """The fusion decoder over the towers' outputs -> [B, V, H, W, C];
        checkpointed under `remat_fusion` while autograd records."""
        if self.remat_fusion and torch.is_grad_enabled():
            combined, _ = checkpoint(self.combine_clip_visual, clip_outputs,
                                     vis, textuals, use_reentrant=False)
        else:
            combined, _ = self.combine_clip_visual(clip_outputs, vis, textuals)
        n = combined.shape[0]
        return combined.reshape((n // self.n_views, self.n_views)
                                + combined.shape[1:])

    def compute_features(self, src_images: torch.Tensor,
                         clip_tokens: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """The fused full-resolution features of the language variants; the
        backbone's (`encode`) otherwise."""
        if self.fusion is None:
            return self.encode(src_images)
        return self.apply_fusion(*self.fusion_inputs(src_images, clip_tokens))

    # ------------------------------------------------------------- energy

    def prepare(self, src_images: torch.Tensor,
                batched_features: torch.Tensor) -> Prepared:
        """The pose-independent part of `energy` for images [B, V, H, W, 3]
        and features [B, V, H, W, C]: compute it once per scene."""
        b, v = src_images.shape[:2]
        combined = torch.cat([src_images * 2.0 - 1.0, batched_features],
                             dim=-1)
        combined = combined.reshape((b * v,) + combined.shape[2:])
        if not self.corner_gather:
            return Prepared(b, v, combined, None)
        corner = make_corner_image(self.fine_embedding.project_image(combined))
        return Prepared(b, v, None, corner)

    def probe_weights(self) -> Optional[ProbeWeights]:
        """The layers the probe kernels read, or None where the model is
        not one they compute: more than one view, a hash-grid stream, raw
        directions, a readout with an extra stream, a readout activation
        other than relu or elu, a layer without bias or with a compute
        dtype other than f32."""
        emb, ro = self.fine_embedding, self.grasp_readout
        if (self.n_views != 1 or self.hash_cfg is not None
                or not emb.embed_direction_vector or ro.extra_features
                or ro.activation not in ("relu", "elu")
                or emb.layer_0.split != 12 * emb.n_freq):
            return None
        chain = [layer for blk in (*emb.feature_blocks, *emb.fusion_blocks)
                 for layer in (blk.layer_0, blk.layer_1)]
        downscales = [getattr(ro, f"activation_downscale_{j + 1}")
                      for j in range(ro.n_activations)]
        mods = [emb.layer_0, *chain, *downscales,
                ro.combined_activation_downscale]
        if any(m.bias is None or m.dtype not in (None, torch.float32)
               for m in mods):
            return None
        pair = [(m.weight, m.bias) for m in mods]
        return ProbeWeights(pair[0], pair[1:1 + len(chain)],
                            pair[1 + len(chain):-1], pair[-1], emb.n_freq,
                            emb.pos_encoding_freq, ro.activation == "elu")

    def _probe_pack(self):
        """`pack_probe` of `probe_weights`, or None where the kernels do not
        compute the model; packed again only when a weight they read is
        replaced or changed in place."""
        w = self.probe_weights()
        key = None if w is None else tuple((t.data_ptr(), t._version)
                                           for t in w.params())
        if getattr(self, "_probe_key", ()) != key:
            self._probe_packed = (pack_probe(w) if key and probe_fits(w)
                                  else None)
            self._probe_key = key
        return self._probe_packed

    def probe_kernel_engages(self, poses: torch.Tensor,
                             prepared: Prepared) -> bool:
        """Whether `energy_prepared` takes the probe chain kernels (the
        module's docstring lists the conditions)."""
        corner = prepared.corner
        if not (poses.is_cuda and poses.dtype == torch.float32
                and corner is not None and corner.dtype == torch.float32):
            return False
        pack = self._probe_pack()
        return pack is not None and probe_grad_free(pack, corner)

    def probe_chain_plain(self, coords: torch.Tensor, pos: torch.Tensor,
                          dirs: torch.Tensor, corner: torch.Tensor,
                          rows_per_image: int) -> torch.Tensor:
        """What the probe kernels compute, in plain PyTorch as the plain
        path computes it: coords [R, 2], pos and dirs [R, 3], corner [I, H,
        W, 4 * hidden] with I * rows_per_image == R -> [R, 64]."""
        rows = coords.shape[0]
        feats = bilinear_gather_corners(
            corner, coords.reshape(rows // rows_per_image, rows_per_image, 2))
        acts = self.fine_embedding(pos, dirs, feats.reshape(rows, -1),
                                   features_projected=True)
        return self.grasp_readout.probe_features(
            acts[tap_slice(self.n_blocks)])

    def probe_inputs(self, poses: torch.Tensor, src_intrinsics: torch.Tensor,
                     src_extrinsics_inv: torch.Tensor):
        """The probes of poses [B, N, 4, 4]: world translations [B, N, P, 3],
        and in each view pixel xy [B, V, N, P, 2], camera-frame positions
        and directions [B, V, N, P, 3]."""
        probe_poses = torch.einsum("bnij,pjk->bnpik", poses,
                                   self.probes.to(poses.dtype))
        translations = probe_poses[..., :3, 3]
        pixel_xy, cam_points = projection.project_probe_points(
            translations, src_intrinsics, src_extrinsics_inv)
        dirs = projection.rotate_directions(
            probe_poses[..., :3, :3], self.z_dir.to(poses.dtype),
            src_extrinsics_inv)
        return translations, pixel_xy, cam_points, dirs

    def energy_prepared(self, poses: torch.Tensor, prepared: Prepared,
                        src_intrinsics: torch.Tensor,
                        src_extrinsics_inv: torch.Tensor) -> torch.Tensor:
        """Energies [B, N] of poses [B, N, 4, 4] in a `prepare`d scene."""
        translations, pixel_xy, cam_points, dirs = self.probe_inputs(
            poses, src_intrinsics, src_extrinsics_inv)
        b, v = prepared.batch, prepared.views
        n, p = poses.shape[1], self.n_probes
        if self.probe_kernel_engages(poses, prepared):
            combined = probe_chain(
                pixel_xy.reshape(-1, 2),
                cam_points.reshape(-1, 3).contiguous(),
                dirs.reshape(-1, 3).contiguous(), prepared.corner, n * p,
                self._probe_packed)
            return self.grasp_readout.pose_energies(combined.reshape(b, n, -1))
        coords = pixel_xy.reshape(b * v, n * p, 2)
        if prepared.corner is not None:
            feats = bilinear_gather_corners(prepared.corner, coords)
        else:
            feats = bilinear_gather(prepared.combined, coords)
        activations = self.fine_embedding(
            cam_points.reshape(b * v, n, p, 3), dirs.reshape(b * v, n, p, 3),
            feats.reshape(b * v, n, p, feats.shape[-1]),
            features_projected=prepared.corner is not None)
        extra = None
        if self.hash_cfg is not None:
            # the probes' world positions: view-independent, as the fused
            # activations (leading axis B) are
            extra = hash_encode(self.hash_tables, translations,
                                self.hash_cfg).to(activations[-1].dtype)
        return self.grasp_readout(activations[tap_slice(self.n_blocks)],
                                  extra)

    def energy(self, poses, src_images, src_intrinsics, src_extrinsics_inv,
               batched_features) -> torch.Tensor:
        """Energies [B, N] of candidate poses [B, N, 4, 4]."""
        return self.energy_prepared(
            poses, self.prepare(src_images, batched_features),
            src_intrinsics, src_extrinsics_inv)

    def forward(self, poses, src_images, src_intrinsics, src_extrinsics_inv,
                batched_features=None) -> torch.Tensor:
        if batched_features is None:
            batched_features = self.encode(src_images)
        return self.energy(poses, src_images, src_intrinsics,
                           src_extrinsics_inv, batched_features)

    def energy_from_pose_params_prepared(
            self, translations, rotations, prepared: Prepared,
            src_intrinsics, src_extrinsics_inv,
            rotation_representation: str = "quaternion") -> torch.Tensor:
        """Energy as a function of raw pose parameters (t [B, N, 3], r
        [B, N, 4 | 6]) in a prepared scene; differentiable in (t, r)."""
        poses = se3.pose_to_matrix(translations, rotations,
                                   rotation_representation)
        return self.energy_prepared(poses, prepared, src_intrinsics,
                                    src_extrinsics_inv)

    def energy_from_pose_params(self, translations, rotations, src_images,
                                src_intrinsics, src_extrinsics_inv,
                                batched_features,
                                rotation_representation: str = "quaternion"):
        return self.energy_from_pose_params_prepared(
            translations, rotations,
            self.prepare(src_images, batched_features), src_intrinsics,
            src_extrinsics_inv, rotation_representation)
