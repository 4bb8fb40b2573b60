"""Multi-rank dry run of the parallel package at tiny widths (the port's
counterpart of the JAX package's `dryrun_multichip`).

    python -m tcnerf_torch.parallel.dryrun --world 4 --device cpu
    torchrun --nproc-per-node 4 -m tcnerf_torch.parallel.dryrun

The first spawns `--world` gloo ranks (`Launch`: start method `spawn`,
one thread each, a `FileStore` in a temporary directory) and waits for
them at most JOIN_TIMEOUT seconds; a rank that fails makes the parent
raise with its traceback. Under `torchrun` each process is one rank on
its own card and the group is NCCL. Every rank runs `rank_checks`, the
same code at every world size (the tests and chip_smoke.py call it too):
  1. the sharded train step (`mesh.nerf_train_step_sharded`, in f64)
     against the one-process `nerf_train_step` on the global batch with
     the same draws, two updates with a warm-up of one step (the first at
     learning rate 0, the second at the full rate): the loss, the averaged
     gradients, the parameters after the second update, and the
     parameters bit-identical on every rank;
  2. the explicit train step (`explicit.make_explicit_train_step`): with
     each rank's block of the global draws it is the sharded step when the
     mesh's data axis is 1 (else the two differ by the batch statistics,
     reported); on its own streams it is deterministic, finite and
     replicated, bumps the step count and fills Adam's second moment;
  3. sharded pose ascent: energies, dE/d(t, r) of `make_explicit_ascent_step`
     and two `optimize_pose` steps on each rank's block of guesses,
     gathered, against the whole (f64);
  4. sharded full-image serving (`serve.render_image_sharded`) against
     `models.inference.render_all_rays` with one generator seed;
and reports the layout (mesh position, batch and guess blocks,
`host_shard_indices`, `global_batch_array`). Rank 0 prints one summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.rays import get_specific_rays
from ..data.synthetic import camera_ring
from ..models.grasp import GraspEBM
from ..models.inference import render_all_rays
from ..models.renderer import MVNeRFRenderer
from ..models.training import (create_train_state, draw_samples,
                               make_nerf_optimizer, nerf_train_step)
from ..opt.pose_optimizer import PoseOptimizer, frozen
from ..params import init_params
from .distributed import (GROUP_TIMEOUT, all_gather_rows, backend_for,
                          global_batch_array, host_shard_indices,
                          initialize)
from .explicit import (gather_guesses, make_explicit_ascent_step,
                       make_explicit_train_step)
from .mesh import (RAY_SPEC, Sharding, destroy_mesh, make_mesh,
                   nerf_train_step_sharded, pose_shardings, shard_guesses,
                   shard_nerf_batch, shard_params)
from .serve import render_image_sharded

H, W = 32, 40
NERF = dict(n_views=1, n_samples=8, n_features=8, near=0.3, far=1.3,
            original_image_size=(H, W), fusion="without", n_blocks=2,
            hidden_size=32, vit_size=(32, 32), vit_dim=32, vit_heads=2,
            vit_hooks=(1, 2, 3, 4))
GRASP = dict(n_views=1, n_features=32, original_image_size=(H, W),
             n_5d_poses=3, n_blocks=2, hidden_size=32, vit_size=(32, 32),
             vit_patch=16, vit_dim=32, vit_heads=2, vit_hooks=(1, 2, 3, 4))
WORKSPACE = ((0.35, 0.85), (-0.25, 0.25), (0.0, 0.2))
# bars of the comparisons with one process: the train steps and the ascent
# in f64 (in f32 the step's gradient is ill-conditioned: the fine loss
# reaches the coarse weights through the inverse-CDF resampling, which
# turns the rounding of another batch split into ~1e-2 of the largest
# gradient; f64 holds 1e-14) at 1e-9; the f32 render at the JAX suite's
# 1e-5
TRAIN_TOL, RENDER_TOL, ASCENT_TOL = 1e-9, 1e-5, 1e-9
JOIN_TIMEOUT = 120.0    # seconds the parent waits for the spawned ranks


@dataclasses.dataclass
class Case:
    """The inputs of `rank_checks`, global and in numpy (states as tensors).
    `train_draws` (global (u_coarse, u_fine) [B, R, S]), `explicit_draws`
    (per rank its own (u_coarse, u_fine) [B / data, R / ray, S], which the
    explicit step then also runs on) and `render_draws` (per chunk
    (u_coarse, u_fine) [1, chunk, S], covering the padded chunk count of
    the world size) are optional: by default the samples come from
    generators seeded with `seed`."""
    nerf_cfg: dict
    nerf_state: dict
    inputs: Tuple[np.ndarray, ...]      # ray_o, ray_d, src, K, ext_inv
    labels: np.ndarray                  # [B, R, 3]
    render_feats: np.ndarray            # [1, 1, H, W, C]
    tgt_pose: np.ndarray
    tgt_k3: np.ndarray
    chunk: int
    grasp_cfg: dict
    grasp_state: dict
    grasp_scene: Tuple[np.ndarray, ...]  # images, K, ext_inv [1, 1, ...]
    grasp_features: np.ndarray           # [1, 1, H, W, C]
    guesses: List[np.ndarray]            # [1, N, 3], [1, N, 4]
    index_cases: Sequence[Tuple[int, Optional[int]]]
    seed: int = 0
    train_draws: Optional[Tuple[np.ndarray, np.ndarray]] = None
    explicit_draws: Optional[list] = None
    render_draws: Optional[list] = None


def tiny_case() -> Case:
    """A case at tiny widths from numpy seeds and `init_params`: a 1-view
    "without" renderer (hidden 32, 2 blocks, 8 samples, ViT 32^2 dim 32),
    a [2, 32] ray batch through a target camera of a 2-camera ring, a
    32x40 target view in 128-ray chunks over random features, a GraspEBM
    (3 5-d poses, hidden 32, 2 blocks) over one view and random features,
    and 32 guesses in the workspace."""
    batch, n_rays, n_guesses, seed = 2, 32, 32, 0
    rng = np.random.default_rng(seed)
    src_cfg, tgt_cfg = camera_ring(2, height=H, width=W, azimuth_span=0.6)
    k4 = np.eye(4, dtype=np.float32)
    k4[:3, :3] = src_cfg["intrinsics"].reshape(3, 3)
    ext = np.linalg.inv(src_cfg["pose"]).astype(np.float32)
    k3 = tgt_cfg["intrinsics"].reshape(3, 3).astype(np.float32)
    ro, rd = zip(*[get_specific_rays(rng.uniform(0, W - 1, n_rays),
                                     rng.uniform(0, H - 1, n_rays),
                                     tgt_cfg["pose"], k3)
                   for _ in range(batch)])
    inputs = (np.stack(ro).astype(np.float32),
              np.stack(rd).astype(np.float32),
              rng.uniform(size=(batch, 1, H, W, 3)).astype(np.float32),
              np.tile(k4, (batch, 1, 1, 1)), np.tile(ext, (batch, 1, 1, 1)))
    labels = rng.uniform(size=(batch, n_rays, 3)).astype(np.float32)
    nerf = MVNeRFRenderer(**NERF)
    init_params(nerf, torch.Generator().manual_seed(seed))
    grasp = GraspEBM(**GRASP)
    init_params(grasp, torch.Generator().manual_seed(seed + 1))
    t = rng.uniform([lo for lo, _ in WORKSPACE], [hi for _, hi in WORKSPACE],
                    (1, n_guesses, 3))
    q = rng.normal(size=(1, n_guesses, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return Case(
        nerf_cfg=NERF, nerf_state=nerf.state_dict(), inputs=inputs,
        labels=labels,
        render_feats=rng.normal(size=(1, 1, H, W, 8)).astype(np.float32),
        tgt_pose=tgt_cfg["pose"].astype(np.float32), tgt_k3=k3, chunk=128,
        grasp_cfg=GRASP, grasp_state=grasp.state_dict(),
        grasp_scene=(inputs[2][:1], k4[None, None], ext[None, None]),
        grasp_features=rng.normal(size=(1, 1, H, W, 32)).astype(np.float32),
        guesses=[t.astype(np.float32), q.astype(np.float32)],
        index_cases=[(10, None), (10, 3), (7, 5), (1, None)], seed=seed)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).double() for t in tensors])


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _replicated(tensors) -> bool:
    """Whether the tensors are bit-identical on every rank."""
    rows = all_gather_rows(_flat(tensors)[None])
    return bool((rows == rows[:1]).all())


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"rank {dist.get_rank()}: {what}")


def _train_checks(mesh, case: Case, dev, out: dict) -> str:
    """Checks 1 and 2 (see the module docstring), in f64."""
    dt = torch.float64

    def fresh():
        model = MVNeRFRenderer(**case.nerf_cfg)
        model.load_state_dict(case.nerf_state)
        model = model.to(dev, dt)
        # warm-up 1: the first update runs at learning rate 0 (and fills
        # Adam's moments), the second at the full rate
        return create_train_state(model, make_nerf_optimizer(
            model, warmup_steps=1))

    def gen():
        return torch.Generator(device=dev).manual_seed(case.seed)

    def params(state):
        return list(state.model.parameters())

    def grads(state):
        return _flat(p.grad for p in params(state))

    def t(a):
        return torch.as_tensor(a, device=dev, dtype=dt)

    def state_dict(state):
        return {k: v.detach().cpu().clone()
                for k, v in state.model.state_dict().items()}

    g_in, g_lab = tuple(map(t, case.inputs)), t(case.labels)
    draws = None if case.train_draws is None else tuple(
        map(t, case.train_draws))
    local_in, local_lab = shard_nerf_batch(g_in, g_lab, mesh)

    ref, sharded = fresh(), fresh()
    shard_params(sharded.model, sharded.optimizer, mesh)
    before = _flat(params(sharded))
    for i in range(2):     # the same batch and draws both times
        _, m_ref = nerf_train_step(ref, g_in, g_lab, gen(), draws=draws)
        _, m_sh = nerf_train_step_sharded(sharded, local_in, local_lab, mesh,
                                          gen(), draws=draws)
        if i == 0:
            loss_ref, loss_sh = float(m_ref["loss"]), float(m_sh["loss"])
            d_grad = _rel(grads(sharded), grads(ref))
    d_loss = abs(loss_sh - loss_ref) / abs(loss_ref)
    d_param = _rel(_flat(params(sharded)), _flat(params(ref)))
    moved = float((_flat(params(sharded)) - before).abs().max())
    out.update(loss=loss_sh, params=state_dict(sharded))
    out["diffs"].update(loss=d_loss, grads=d_grad, params=d_param)
    _check(np.isfinite(loss_sh) and d_loss <= TRAIN_TOL,
           f"sharded loss {loss_sh} vs one-process {loss_ref}")
    _check(d_grad <= TRAIN_TOL, f"sharded gradients off by {d_grad:.3g}")
    _check(moved > 0 and d_param <= TRAIN_TOL,
           f"params after the second update off by {d_param:.3g} (moved "
           f"{moved:.3g})")
    _check(_replicated(params(sharded)), "params differ across ranks")

    # the explicit step with this rank's block of the same global draws
    explicit = make_explicit_train_step(mesh)
    if draws is None:
        draws = draw_samples(ref.model, *g_in[0].shape[:2], gen(), dev)
        draws = tuple(u.to(dt) for u in draws)
    ex, sh = fresh(), fresh()
    _, m_ex = explicit(ex, local_in, local_lab,
                       draws=tuple(Sharding(mesh, RAY_SPEC).local(u)
                                   for u in draws))
    nerf_train_step_sharded(sh, local_in, local_lab, mesh, draws=draws)
    d_ex = _rel(grads(ex), grads(sh))
    out["explicit_global_draws_loss"] = float(m_ex["loss"])
    out["diffs"]["explicit_vs_sharded"] = d_ex
    if dict(zip(mesh.mesh_dim_names, mesh.shape))["data"] == 1:
        _check(float(m_ex["loss"]) == loss_sh and d_ex <= TRAIN_TOL,
               f"explicit step with the global draws is not the sharded "
               f"step (gradients off by {d_ex:.3g})")
    if case.explicit_draws is not None:      # this rank's own draws
        ex = fresh()
        for _ in range(2):
            _, m = explicit(ex, local_in, local_lab, draws=tuple(
                map(t, case.explicit_draws[dist.get_rank()])))
        out.update(explicit_draws_loss=float(m["loss"]),
                   explicit_draws_params=state_dict(ex))
        _check(_replicated(params(ex)), "explicit step lost replication")

    # the explicit step on each shard's own stream
    runs = []
    for _ in range(2):
        s = fresh()
        for _ in range(2):
            _, m = explicit(s, local_in, local_lab, seed=case.seed + 1)
        runs.append((s, float(m["loss"])))
    (s_ex, l_ex), (_, l_ex2) = runs
    nu = sum(float(st["exp_avg_sq"].sum())
             for st in s_ex.optimizer.adam.state.values())
    out.update(explicit_loss=l_ex, explicit_step=s_ex.step,
               explicit_nu=nu)
    _check(np.isfinite(l_ex) and l_ex == l_ex2,
           f"explicit step not deterministic: {l_ex} vs {l_ex2}")
    _check(s_ex.step == 2 and np.isfinite(nu) and nu > 0,
           "explicit step: step count or Adam's second moment")
    _check(_replicated(params(s_ex)), "explicit step lost replication")
    return (f"sharded loss={loss_sh:.6f} (one-process {loss_ref:.6f}, rel d="
            f"{d_loss:.2e}; grads max-rel d={d_grad:.2e}; params after the "
            f"second update max-rel d={d_param:.2e}, identical on "
            f"{dist.get_world_size()} ranks) | explicit with the global "
            f"draws: grads max-rel d={d_ex:.2e} from the sharded step; "
            f"explicit loss={l_ex:.6f} deterministic, replicated")


def _ascent_checks(mesh, case: Case, dev, out: dict) -> str:
    """Check 3: energies, ascent gradients and optimize_pose on this rank's
    block of guesses, gathered, against the whole, in f64."""
    model = GraspEBM(**case.grasp_cfg)
    model.load_state_dict(case.grasp_state)
    model = model.to(dev, torch.float64).eval()
    opt = PoseOptimizer(model=model, workspace_bounds=WORKSPACE,
                        n_initial_guesses=case.guesses[0].shape[1],
                        n_images=case.grasp_scene[0].shape[1])
    scene = opt.prepare(case.grasp_scene, case.grasp_features)
    whole = opt.init_state(case.guesses)
    block = opt.init_state([pose_shardings(mesh).local(g).cpu().numpy()
                            for g in case.guesses])
    e_want = opt.compute_current_grasp_success(whole, scene)
    e_got = gather_guesses(opt.compute_current_grasp_success(block, scene),
                           mesh, dim=0)
    energy_fn = opt._energies
    with frozen(model):
        t = whole.translations.detach().requires_grad_(True)
        r = whole.rotations.detach().requires_grad_(True)
        want = torch.autograd.grad(-energy_fn(t, r, scene).sum(), (t, r))
        got = make_explicit_ascent_step(mesh, energy_fn)(
            whole.translations, whole.rotations, scene)
    got = [gather_guesses(g, mesh) for g in got]
    stepped = [opt.optimize_pose(s, scene, (True, True), 2)[0]
               for s in (whole, block)]
    poses_want = (stepped[0].translations, stepped[0].rotations)
    poses_got = [gather_guesses(x, mesh) for x in
                 (stepped[1].translations, stepped[1].rotations)]
    d_e = _rel(e_got, e_want)
    d_g = max(_rel(a, b) for a, b in zip(got, want))
    d_p = max(_rel(a, b) for a, b in zip(poses_got, poses_want))
    out.update(energies=e_got.cpu(), ascent_grads=[g.cpu() for g in got])
    out["diffs"].update(energies=d_e, ascent_grads=d_g, poses=d_p)
    _check(d_e <= ASCENT_TOL and d_g <= ASCENT_TOL and d_p <= ASCENT_TOL,
           f"sharded ascent off: energies {d_e:.3g}, grads {d_g:.3g}, "
           f"poses {d_p:.3g}")
    return (f"sharded ascent max-rel dE={d_e:.2e} dgrad={d_g:.2e} "
            f"dpose={d_p:.2e} ({case.guesses[0].shape[1]} guesses)")


def _render_checks(mesh, case: Case, dev, out: dict) -> str:
    """Check 4: the sharded full-image render against render_all_rays."""
    model = MVNeRFRenderer(**case.nerf_cfg).to(dev)
    model.load_state_dict(case.nerf_state)
    model.eval()

    def t(a):
        return torch.as_tensor(a, device=dev)

    h, w = case.render_feats.shape[2:4]
    args = (model, t(case.inputs[2][:1]), t(case.inputs[3][:1]),
            t(case.inputs[4][:1]), t(case.render_feats), t(case.tgt_pose),
            t(case.tgt_k3), h, w, case.chunk)
    with torch.no_grad():
        if case.render_draws is not None:
            rgb, depth = render_image_sharded(
                mesh, *args, draws=[tuple(t(u) for u in d)
                                    for d in case.render_draws])
            out.update(render_draws_rgb=rgb.cpu(),
                       render_draws_depth=depth.cpu())
        rgb, depth = render_image_sharded(
            mesh, *args,
            generator=torch.Generator(device=dev).manual_seed(case.seed))
        rgb1, depth1 = render_all_rays(
            *args,
            generator=torch.Generator(device=dev).manual_seed(case.seed))
    d_rgb, d_depth = _rel(rgb, rgb1), _rel(depth, depth1)
    out.update(render_rgb=rgb.cpu(), render_depth=depth.cpu())
    out["diffs"]["render"] = max(d_rgb, d_depth)
    _check(tuple(rgb.shape) == (h, w, 3) and d_rgb <= RENDER_TOL
           and d_depth <= RENDER_TOL,
           f"sharded render off by {d_rgb:.3g} / {d_depth:.3g}")
    return f"sharded render {h}x{w} max-rel dRGB={d_rgb:.2e}"


def rank_checks(mesh, case: Case, device) -> dict:
    """Checks 1-4 on this rank (see the module docstring); raises on a
    failed check. Returns this rank's results (tensors on the CPU) with a
    one-line summary under "summary"."""
    dev = torch.device(device)
    world = dist.get_world_size()
    out = {"rank": dist.get_rank(),
           "coordinate": tuple(int(c) for c in mesh.get_coordinate()),
           "diffs": {}}
    local_in, local_lab = shard_nerf_batch(case.inputs, case.labels, mesh)
    out["batch_block"] = [x.cpu() for x in local_in + (local_lab,)]
    out["guess_block"] = [shard_guesses(g, mesh).cpu()
                                for g in case.guesses]
    out["indices"] = {nr: host_shard_indices(*nr) for nr in case.index_cases}
    out["global_batch"] = global_batch_array(
        np.full((2, 3), out["rank"], np.float32), mesh).cpu()
    _check(torch.equal(out["global_batch"][:, 0],
                       torch.arange(world).repeat_interleave(2).float()),
           "global_batch_array: not the local batches in rank order")
    try:
        shard_guesses(np.zeros((1, world + 1)), mesh)
        out["unequal_raises"] = False
    except ValueError:
        out["unequal_raises"] = True
    _check(out["unequal_raises"] == (world > 1), "unequal shard guard")
    parts = [_train_checks(mesh, case, dev, out),
             _ascent_checks(mesh, case, dev, out),
             _render_checks(mesh, case, dev, out)]
    out["summary"] = (f"dryrun(world={world}, mesh={tuple(mesh.shape)}, "
                      f"{dist.get_backend()}): " + " | ".join(parts) + " OK")
    return out


def _data_axis(world: int) -> int:
    return 2 if world % 2 == 0 else 1


def _rank_entry(rank: int, world: int, device: str, tmp: str) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev),
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 world),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        case = torch.load(os.path.join(tmp, "case.pt"), weights_only=False)
        mesh = make_mesh(world, data_axis=_data_axis(world), device=dev)
        out = rank_checks(mesh, case, dev)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        destroy_mesh()


class Launch:
    """`world` spawned ranks running `rank_checks` (gloo on the CPU, NCCL
    on one card each); `wait` collects their results."""

    def __init__(self, world: int, device: str = "cpu",
                 case: Optional[Case] = None):
        self.world = world
        self._tmp = tempfile.TemporaryDirectory(prefix="tcnerf_dryrun_")
        tmp = self._tmp.name
        torch.save(case if case is not None else tiny_case(),
                   os.path.join(tmp, "case.pt"))
        self._ctx = mp.start_processes(_rank_entry,
                                       args=(world, device, tmp),
                                       nprocs=world, join=False,
                                       start_method="spawn")

    def wait(self) -> List[dict]:
        """Each rank's results. Raises with the failing rank's traceback,
        or TimeoutError after JOIN_TIMEOUT seconds; the ranks are killed
        and the temporary directory removed either way."""
        timeout = JOIN_TIMEOUT
        deadline = time.monotonic() + timeout
        try:
            while not self._ctx.join(
                    timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"dryrun: {self.world} ranks still "
                                       f"running after {timeout} s")
            return [torch.load(os.path.join(self._tmp.name, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self.world)]
        finally:
            self.close()

    def close(self) -> None:
        """Kill the ranks still running and remove the directory."""
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
        self._tmp.cleanup()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="cpu or cuda (default cuda)")
    args = parser.parse_args(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:    # torchrun
        dev = torch.device(args.device or "cuda")
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        world = int(os.environ["WORLD_SIZE"])
        initialize(num_processes=world, device=dev)
        try:
            mesh = make_mesh(world, data_axis=_data_axis(world), device=dev)
            out = rank_checks(mesh, tiny_case(), dev)
        finally:
            destroy_mesh()
        if out["rank"] == 0:
            print(out["summary"])
        return 0
    device = args.device or "cuda"
    if torch.device(device).type == "cuda" and (
            torch.cuda.device_count() < args.world):
        raise RuntimeError(f"dryrun: {args.world} ranks need as many cards "
                           f"({torch.cuda.device_count()} present); pass "
                           f"--device cpu for gloo ranks")
    results = Launch(args.world, device, tiny_case()).wait()
    print(results[0]["summary"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
