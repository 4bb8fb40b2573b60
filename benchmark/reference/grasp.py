"""The grasp energy of the reference and its pose ascent.

Each candidate gripper pose expands into 6 gripper-frame bases x
n_5d_poses z-offsets of probe transforms; every probe's position projects
into each source view, where the NeRF MLP reads the feature image (the
full-resolution features beside the image in [-1, 1], gathered
bilinearly) and returns all its activations; the readout turns the fused
stream's into one energy per pose, summed over the source views.

The ascent: uniform guesses over the workspace (translation, then xyz
Euler angles, from one numpy stream, per guess), then per step the gradient
of the summed energy with respect to (t, quaternion), clipped to +-1, an
Adam step with optax's arithmetic (bias correction at count + 1, the
learning rate exponential_decay(init, decay) read at the count before the
update), quaternions renormalised, translations clipped to the workspace.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation
from torch import nn

from .encoder import VisualFeatures, full_resolution
from .field import Embedding, ResBlock, act, homogeneous, project
from .layers import Dense, bilinear_gather


def probe_transforms(n_5d_poses: int) -> np.ndarray:
    """[6 * n, 4, 4]: bases at (0, +-y), and at (-+x, +-y, z) turned
    +-pi/2 about y, each followed by n z-offsets spanning
    +-(x - 0.005)."""
    bx, by, bz = 0.02, 0.015, 0.0125

    def affine(t, euler=(0.0, 0.0, 0.0)):
        m = np.eye(4)
        m[:3, :3] = Rotation.from_euler("xyz", euler).as_matrix()
        m[:3, 3] = t
        return m

    half = (n_5d_poses - 1) // 2
    step = (bx - 0.005) / ((n_5d_poses - 1) / 2)
    bases = [affine([0, by, 0]), affine([0, -by, 0]),
             affine([-bx, by, bz], [0, np.pi / 2, 0]),
             affine([bx, by, bz], [0, -np.pi / 2, 0]),
             affine([-bx, -by, bz], [0, np.pi / 2, 0]),
             affine([bx, -by, bz], [0, -np.pi / 2, 0])]
    return np.asarray([b @ affine([0, 0, i * step]) for b in bases
                       for i in range(-half, half + 1)], np.float32)


class Readout(nn.Module):
    """Per fused activation a 64-wide downscale, their concatenation to 64,
    the probes flattened, two residual blocks, relu and one output."""

    def __init__(self, hidden: int, n_probes: int, activation: str,
                 use_bias: bool, n_acts: int = 4):
        super().__init__()
        self.activation, self.n_acts = activation, n_acts
        for i in range(n_acts):
            self.add_module(f"activation_downscale_{i + 1}", Dense(hidden, 64))
        self.combined_activation_downscale = Dense(64 * n_acts, 64)
        self.readout_block_0 = ResBlock(n_probes * 64, 128, 64, shortcut=True,
                                        activation=activation)
        self.readout_block_1 = ResBlock(64, 64, 64, activation=activation)
        self.readout_head = nn.Module()
        self.readout_head.output_layer = Dense(64, 1, use_bias=use_bias)

    def forward(self, acts: List[torch.Tensor]) -> torch.Tensor:
        a = act(self.activation)
        ds = [a(getattr(self, f"activation_downscale_{i + 1}")(x))
              for i, x in enumerate(acts[:self.n_acts])]
        x = a(self.combined_activation_downscale(torch.cat(ds, -1)))
        x = x.reshape(x.shape[:-2] + (-1,))
        x = self.readout_block_1(self.readout_block_0(x))
        return self.readout_head.output_layer(torch.relu(x))[..., 0]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw, normalised first -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        -1).reshape(q.shape[:-1] + (3, 3))


def pose_matrix(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    top = torch.cat([quat_to_matrix(q), t[..., None]], -1)
    last = torch.zeros(top.shape[:-2] + (1, 4), dtype=t.dtype, device=t.device)
    last[..., 0, 3] = 1.0
    return torch.cat([top, last], -2)


class GraspModel(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.fine_embedding = Embedding(c["n_features"] + 3, c["n_blocks"],
                                        c["hidden"], c["n_views"])
        self.visual_features = VisualFeatures(c)
        n_probes = 6 * c["n_5d_poses"]
        n_fused = c["n_blocks"] - c["n_blocks"] // 2 + 1
        self.grasp_readout = Readout(c["hidden"], n_probes,
                                     c["readout_activation"],
                                     c["readout_bias"], min(n_fused, 4))
        self.register_buffer("probes", torch.as_tensor(
            probe_transforms(c["n_5d_poses"])), persistent=False)

    def features(self, images_flat):
        return full_resolution(self.visual_features(images_flat))

    def energy(self, poses: torch.Tensor, combined: torch.Tensor,
               intrinsics, extrinsics_inv) -> torch.Tensor:
        """poses [B, N, 4, 4]; combined [B * V, H, W, C + 3] (image in
        [-1, 1], features); cameras [B, V, 4, 4] -> energies [B, N]."""
        b, n = poses.shape[:2]
        v = intrinsics.shape[1]
        probes = poses[:, :, None] @ self.probes            # [B, N, P, 4, 4]
        p = probes.shape[2]
        xy, cam = project(probes[..., :3, 3], intrinsics, extrinsics_inv)
        feats = bilinear_gather(combined, xy.reshape(b * v, n * p, 2))
        axis = probes[..., :3, :3] @ torch.tensor(
            [0.0, 0.0, 1.0], dtype=poses.dtype, device=poses.device)
        dirs = (homogeneous(axis).reshape(b, 1, -1, 4)
                @ extrinsics_inv.transpose(-1, -2))[..., :3]
        acts = self.fine_embedding(cam.reshape(b * v, n, p, 3),
                                   dirs.reshape(b * v, n, p, 3),
                                   feats.reshape(b * v, n, p, -1))
        return self.grasp_readout(acts[self.c["n_blocks"] // 2 + 1:])


def initial_guesses(workspace, n: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    """(t [1, n, 3], q [1, n, 4]) float32: per guess three translation and
    three xyz Euler draws from one stream, the Euler angles to a unit
    quaternion through the rotation matrix."""
    rng = np.random.default_rng(rng)
    b = np.asarray(workspace, np.float64)
    lo = np.concatenate([b[:, 0], np.zeros(3)])
    hi = np.concatenate([b[:, 1], np.full(3, 2 * np.pi)])
    draws = rng.uniform(lo, hi, size=(n, 6))
    m = Rotation.from_euler("xyz", draws[:, 3:]).as_matrix()
    q = Rotation.from_matrix(m).as_quat()
    return (draws[None, :, :3].astype(np.float32),
            q[None].astype(np.float32))


def adam_step(g, mu, nu, count: int, lr: float):
    mu = 0.1 * g + 0.9 * mu
    nu = 0.001 * g * g + 0.999 * nu
    k = count + 1
    mu_hat = mu / float(1 - np.float32(0.9) ** np.float32(k))
    nu_hat = nu / float(1 - np.float32(0.999) ** np.float32(k))
    step = mu_hat / (torch.sqrt(nu_hat) + 1e-8)
    return -float(np.float32(lr)) * step, mu, nu


def ascent(model: GraspModel, images: torch.Tensor, intrinsics, ext_inv,
           t0: np.ndarray, q0: np.ndarray, opt: dict) -> Dict[str, object]:
    """images [1, n_images, H, W, 3] in [0, 1] and cameras [1, n_images,
    4, 4], one view per image (folded to a batch of n_images) -> the final
    energies [N] and poses [N, 4, 4] after the synchronised ascent."""
    dev = images.device
    n_img = images.shape[1]
    flat = images[0]
    with torch.no_grad():
        feats = model.features(flat)
        combined = torch.cat([flat * 2.0 - 1.0, feats], -1)
    intr = intrinsics[0][:, None]                        # [B, 1, 4, 4]
    ext = ext_inv[0][:, None]
    bounds = torch.as_tensor(np.asarray(opt["workspace"], np.float32),
                             device=dev)
    t = torch.as_tensor(t0, device=dev)
    q = torch.as_tensor(q0, device=dev)
    state = {k: [torch.zeros_like(x), torch.zeros_like(x)]
             for k, x in (("t", t), ("q", q))}

    def energies(t, q):
        poses = pose_matrix(t, q).expand(n_img, -1, -1, -1)
        return model.energy(poses, combined, intr, ext).sum(0)

    for p in model.parameters():
        p.requires_grad_(False)
    for k in range(opt["steps"]):
        t_, q_ = t.detach().requires_grad_(), q.detach().requires_grad_()
        with torch.enable_grad():
            g_t, g_q = torch.autograd.grad(-energies(t_, q_).sum(), [t_, q_])
        lr_t, lr_r = (np.float32(opt[f"lr_{x}"])
                      * np.float32(opt[f"decay_{x}"]) ** np.float32(k)
                      for x in "tr")
        up, *state["t"] = adam_step(g_t.clamp(-1, 1), *state["t"], k, lr_t)
        t = t + up
        up, *state["q"] = adam_step(g_q.clamp(-1, 1), *state["q"], k, lr_r)
        q = q + up
        if opt["clip_translation"]:
            t = torch.minimum(torch.maximum(t, bounds[:, 0]), bounds[:, 1])
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    with torch.no_grad():
        e = energies(t, q)
        poses = pose_matrix(t, q)[0]
    return {"energies": e, "poses": poses, "combined": combined,
            "intr": intr, "ext": ext}


@torch.no_grad()
def energies_at(model: GraspModel, poses: torch.Tensor, combined, intr, ext
                ) -> torch.Tensor:
    """Summed energies [N] of pose matrices [N, 4, 4] in a scene."""
    b = intr.shape[0]
    return model.energy(poses[None].expand(b, -1, -1, -1), combined, intr,
                        ext).sum(0)
