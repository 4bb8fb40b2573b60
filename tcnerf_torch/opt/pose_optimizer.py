"""Grasp-pose optimization by gradient ascent on the energy
(tcnerf/opt/pose_optimizer.py).

Thousands of random SE(3) guesses are held as (translation, quaternion | 6d)
tensors. Each step differentiates the summed energy with respect to them
(`torch.autograd.grad`; the model's parameters and the prepared scene stay
outside autograd), clips the gradient element-wise to +-1, and takes an Adam
step written with optax's arithmetic: b1 0.9, b2 0.999, eps 1e-8, the bias
correction at count + 1 and the learning rate `exponential_decay(init,
decay)` read at the count before the update. Translations and rotations
have separate optimizer states; a phase that trains only one of them
advances only its state. After each step quaternions (or both 6d halves)
are renormalized and, with `clip_translation`, translations are clipped to
the workspace. `n_images` source views fold into the model's [batch,
n_views] layout; the poses are tiled over the batch and the energies
summed over it.

The JAX package jits the whole ascent as one `lax.scan`; here it is a
Python loop of steps over a scene prepared once (`GraspEBM.prepare`).
`prepare` is the span "tcnerf.grasp.prepare" and each ascent step the span
"tcnerf.grasp.step" (`utils/profiling.py`).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ..core import se3
from ..models.grasp import GraspEBM, Prepared
from ..tasks.transform import Affine
from ..utils.profiling import span
from .schedules import exponential_decay

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamState:
    """optax `scale_by_adam` moments and the shared update count."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor

    @classmethod
    def zeros_like(cls, p: torch.Tensor) -> "AdamState":
        return cls(0, torch.zeros_like(p), torch.zeros_like(p))


def adam_direction(g: torch.Tensor, state: AdamState
                   ) -> Tuple[torch.Tensor, AdamState]:
    """optax `scale_by_adam` of gradient `g`: the bias-corrected
    mu_hat / (sqrt(nu_hat) + eps), and the next state."""
    mu = (1 - B1) * g + B1 * state.mu
    nu = (1 - B2) * (g * g) + B2 * state.nu
    count = state.count + 1

    def correction(decay):       # 1 - decay^count in the moments' dtype
        dt = np.float64 if g.dtype == torch.float64 else np.float32
        return float(1 - dt(decay) ** dt(count))

    mu_hat = mu / correction(B1)
    nu_hat = nu / correction(B2)
    return mu_hat / (torch.sqrt(nu_hat) + EPS), AdamState(count, mu, nu)


def adam_update(g: torch.Tensor, state: AdamState, lr: float
                ) -> Tuple[torch.Tensor, AdamState]:
    """optax.adam's update of gradient `g` at learning rate `lr` (the
    schedule at `state.count`); returns (update, next state)."""
    direction, state = adam_direction(g, state)
    # the schedule's rate is float32 (schedules.py), as in the JAX package
    return -np.float32(lr) * direction, state


@dataclass
class PoseState:
    translations: torch.Tensor     # [1, N, 3]
    rotations: torch.Tensor        # [1, N, 4] quaternions or [1, N, 6]
    opt_t: AdamState
    opt_r: AdamState


@dataclass
class Scene:
    """One scene folded into the model's [batch, n_views] layout, with its
    pose-independent part prepared."""
    prepared: Prepared
    intrinsics: torch.Tensor       # [batch, n_views, 4, 4]
    extrinsics_inv: torch.Tensor


@contextmanager
def frozen(model: torch.nn.Module):
    """The model's parameters outside autograd for the block's duration."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


@dataclass(eq=False)
class PoseOptimizer:
    """Energy-ascent refiner around a GraspEBM (on its device)."""

    model: GraspEBM
    workspace_bounds: Any
    n_initial_guesses: int = 32
    n_images: int = 3
    n_views: int = 1
    rotation_representation: str = "quaternion"
    clip_translation: bool = False
    init_lr_t: float = 0.01
    decay_t: float = 0.9
    init_lr_r: Optional[float] = None
    decay_r: Optional[float] = None
    schedules: dict = field(default=None, init=False, repr=False)
    _bounds: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        if self.n_images % self.n_views:
            raise ValueError("n_images must be divisible by n_views")
        self.batch_size = self.n_images // self.n_views
        if self.init_lr_r is None:
            self.init_lr_r = self.init_lr_t
        if self.decay_r is None:
            self.decay_r = self.decay_t
        self.workspace_bounds = np.asarray(self.workspace_bounds)
        self._rot_dim = 4 if self.rotation_representation == "quaternion" else 6
        self.reset_optimizer()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        """The poses' and the scene's dtype: the model's parameters'."""
        return next(self.model.parameters()).dtype

    # ---------------------------------------------------------- lifecycle

    def reset_optimizer(self, init_lr_t=None, decay_t=None, init_lr_r=None,
                        decay_r=None):
        """Fresh exponential-decay schedules for t and r (falsy arguments
        take the optimizer's own, as the JAX `or` does)."""
        self.schedules = {
            "t": exponential_decay(init_lr_t or self.init_lr_t,
                                   decay_t or self.decay_t),
            "r": exponential_decay(init_lr_r or self.init_lr_r,
                                   decay_r or self.decay_r)}

    def generate_initial_guesses(self, rng=None, n_initial_guesses=None
                                 ) -> List[np.ndarray]:
        """Uniform random SE(3) guesses in the workspace: [ts [1, N, 3],
        rs [1, N, 4 | 6]] float32. The same bits as N calls of
        `Affine.random(workspace, rng=rng)` (the JAX optimizer's loop):
        per guess 3 translation then 3 euler draws from one stream, the
        euler angles to a quaternion, to a matrix and back, here for all
        guesses at once."""
        n = n_initial_guesses or self.n_initial_guesses
        rng = np.random.default_rng(rng)
        b = np.asarray(self.workspace_bounds, dtype=np.float64)
        lo = np.concatenate([b[:, 0], np.zeros(3)])
        hi = np.concatenate([b[:, 1], np.full(3, 2 * np.pi)])
        draws = rng.uniform(lo, hi, size=(n, 6))
        quat = Rotation.from_euler("xyz", draws[:, 3:]).as_quat()
        matrices = Rotation.from_quat(quat).as_matrix()
        ts = draws[None, :, :3].astype(np.float32)
        if self.rotation_representation == "quaternion":
            rs = Rotation.from_matrix(matrices).as_quat()[None]
        else:
            rs = np.concatenate([matrices[:, :, 0], matrices[:, :, 1]],
                                axis=-1)[None]
        return [ts, rs.astype(np.float32)]

    def init_state(self, initial_guesses) -> PoseState:
        ts, rs = (torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                  device=self.device)
                  for x in initial_guesses)
        assert ts.shape == (1, ts.shape[1], 3)
        assert rs.shape[-1] == self._rot_dim
        return PoseState(ts, rs, AdamState.zeros_like(ts),
                         AdamState.zeros_like(rs))

    # ------------------------------------------------------------ scenes

    @span("tcnerf.grasp.prepare")
    def prepare(self, inputs, features) -> Scene:
        """inputs = (images [1, n_images, H, W, 3], intrinsics, extrinsics_inv
        [1, n_images, 4, 4]) and features [1, n_images, H, W, C] -> the
        folded, prepared scene (once per scene)."""
        dev, dt = self.device, self.dtype

        def fold(x):
            x = torch.as_tensor(x, dtype=dt, device=dev)
            return x.reshape((self.batch_size, self.n_views) + x.shape[2:])

        images, intr, ext = (fold(x) for x in inputs[:3])
        with torch.no_grad():
            prepared = self.model.prepare(images, fold(features))
        return Scene(prepared, intr, ext)

    def _energies(self, t, r, scene: Scene) -> torch.Tensor:
        """Per-guess energy summed over the folded view batch -> [N]."""
        b = self.batch_size
        energies = self.model.energy_from_pose_params_prepared(
            t.expand(b, -1, -1), r.expand(b, -1, -1), scene.prepared,
            scene.intrinsics, scene.extrinsics_inv,
            self.rotation_representation)
        return energies.sum(dim=0)

    def _bounds_on(self, device, dtype) -> torch.Tensor:
        """The workspace bounds on `device`, copied once: a copy from
        pageable host memory at every step would wait for the card."""
        key = (device, dtype)
        if key not in self._bounds:
            self._bounds[key] = torch.as_tensor(self.workspace_bounds,
                                                dtype=dtype, device=device)
        return self._bounds[key]

    def _post_process(self, t, r):
        """Renormalize the rotations, clip the translations."""
        if self.clip_translation:
            b = self._bounds_on(t.device, t.dtype)
            t = torch.minimum(torch.maximum(t, b[:, 0]), b[:, 1])
        if self.rotation_representation == "quaternion":
            r = se3._normalize(r)
        else:
            r = torch.cat([se3._normalize(r[..., :3]),
                           se3._normalize(r[..., 3:])], dim=-1)
        return t, r

    # ------------------------------------------------------- optimization

    def optimize_pose(self, state: PoseState, scene: Scene,
                      train_config=(True, True), n_steps: int = 1):
        """`n_steps` ascent steps on a prepared scene. Returns (state, energy
        trace [n_steps, N]: each step's energies before its update)."""
        train_t, train_r = bool(train_config[0]), bool(train_config[1])
        trace = []
        with frozen(self.model):
            for _ in range(int(n_steps)):
                with span("tcnerf.grasp.step"):
                    t = state.translations.detach().requires_grad_(train_t)
                    r = state.rotations.detach().requires_grad_(train_r)
                    with torch.enable_grad():
                        energies = self._energies(t, r, scene)
                        wanted = [x for x, on in ((t, train_t), (r, train_r))
                                  if on]
                        grads = (torch.autograd.grad(-energies.sum(), wanted)
                                 if wanted else ())
                    trace.append(energies.detach())
                    grads = iter(grads)
                    t, r = t.detach(), r.detach()
                    opt_t, opt_r = state.opt_t, state.opt_r
                    if train_t:
                        up, opt_t = adam_update(
                            torch.clamp(next(grads), -1.0, 1.0), opt_t,
                            self.schedules["t"](opt_t.count))
                        t = t + up
                    if train_r:
                        up, opt_r = adam_update(
                            torch.clamp(next(grads), -1.0, 1.0), opt_r,
                            self.schedules["r"](opt_r.count))
                        r = r + up
                    t, r = self._post_process(t, r)
                    state = PoseState(t, r, opt_t, opt_r)
        return state, torch.stack(trace) if trace else None

    @torch.no_grad()
    def compute_current_grasp_success(self, state: PoseState,
                                      scene: Scene) -> torch.Tensor:
        return self._energies(state.translations, state.rotations, scene)

    # ------------------------------------------------------------ results

    def compute_matrices(self, state: PoseState) -> torch.Tensor:
        return se3.pose_to_matrix(state.translations, state.rotations,
                                  self.rotation_representation)

    def get_results(self, state: PoseState,
                    indices: Optional[Sequence[int]] = None) -> List[Affine]:
        """The poses as Affine transforms (those at `indices`, or all)."""
        matrices = self.compute_matrices(state).cpu().numpy()[0]
        if indices is not None:
            matrices = matrices[np.asarray(indices, dtype=np.int64)]
        return [Affine.from_matrix(m.astype(np.float64)) for m in matrices]


def compute_results(pose_optimizer: PoseOptimizer, input_data, features,
                    return_trajectory: bool = False, init_poses=None,
                    reset_optimizer: bool = True,
                    n_optimization_steps: Any = 1, init_lr_t: float = 0.09,
                    decay_t=None, init_lr_r=None, decay_r=None,
                    sync: bool = False, rng=None):
    """The full refinement schedule: per entry of `n_optimization_steps`,
    a t phase then an r phase (or one joint phase with `sync`), on the
    scene prepared once. Returns (energies, energies, poses, poses,
    seconds, trajectory), as the JAX function does."""
    if reset_optimizer:
        pose_optimizer.reset_optimizer(
            init_lr_t, decay_t,
            init_lr_r if init_lr_r is not None else init_lr_t,
            decay_r if decay_r is not None else decay_t)
    if init_poses is None:
        init_poses = pose_optimizer.generate_initial_guesses(rng)
    state = pose_optimizer.init_state(init_poses)
    scene = pose_optimizer.prepare(input_data, features)

    steps_list: Sequence[int] = (n_optimization_steps
                                 if isinstance(n_optimization_steps, list)
                                 else [n_optimization_steps])
    start = time.time()
    all_poses = []
    if return_trajectory:
        all_poses.append(pose_optimizer.get_results(state))
    for o_steps in steps_list:
        phases = [(True, False), (False, True)] if not sync else [(True, True)]
        for phase in phases:
            state, _ = pose_optimizer.optimize_pose(state, scene, phase,
                                                    o_steps)
            if return_trajectory:
                all_poses.append(pose_optimizer.get_results(state))
    losses = pose_optimizer.compute_current_grasp_success(
        state, scene).cpu().numpy().squeeze()
    duration = time.time() - start
    optimized = pose_optimizer.get_results(state)
    return losses, losses, optimized, optimized, duration, all_poses
