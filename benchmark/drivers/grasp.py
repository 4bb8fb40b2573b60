"""Grasp requests to `GraspPipeline.infer`, one client in a closed loop.

Request i is a new scene: `n_images` seeded random images on a fixed
camera ring (`lib/scenes.py`), `n_guesses` guesses drawn by the program
from a seeded integer. A request's service time runs from the call to its
result on the host (the top-k poses, their scores and every energy); the
client makes its inputs outside it. Set-up builds the model through the
port's config and builder, loads the benchmark's weights and serves
`warmup_units` requests.

The check, once the program is freed: for `check_requests` requests
drawn from the seed, the plain reference (`reference/grasp.py`) encodes
the same images with the same weights, draws the same guesses, runs the
same ascent in float32 (TF32 off) and gives its final energies, and its
energy at each returned pose. Numbers (in units of the standard deviation
of the reference's final energies over the guesses):
  energy_gap_median: the median over guesses of |program - reference|
      final energy, worst request;
  energy_share_off_0.001: the share of the guesses whose gap is over a
      thousandth of the spread, worst request. The ascent's first Adam
      steps are sign-like, so rounding alone sends 10-17% of the guesses
      to another end (one ulp in the guesses does it to the reference
      itself); a fault on a third of the guesses (tiles of the batch left
      out of the ascent) leaves the median and moves this;
  topk_gap: the largest |program score - reference energy at the returned
      pose| over the top-k, worst request.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.lib import harness, port, scenes, weights
from benchmark.lib import work as arithmetic


def setup(ctx):
    c, dev = ctx.config, ctx.device
    from tcnerf_torch.device import resolve_device
    from tcnerf_torch.models.pipeline import GraspPipeline
    from tcnerf_torch.train.grasp_common import build_grasp_model

    resolve_device(dev)      # fp32 pinned, as the port's entry points do
    cfg = port.load(c)
    model = build_grasp_model(cfg, device=dev)
    weights.load_into(model, weights.for_module(model, ctx.seed, dev))
    if "bias_dropped" in ctx.faults:
        weights.drop_biases(model)
    oc = cfg.validation.grasp_opt_config
    pipe = GraspPipeline(
        model=model, params=None,
        workspace_bounds=cfg.generator_grasp.workspace_bounds,
        n_initial_guesses=oc.optimizer_config.n_initial_guesses,
        n_images=oc.optimizer_config.n_images,
        rotation_representation=cfg.grasp_model.get(
            "rotation_representation", "quaternion"),
        clip_translation=oc.optimizer_config.clip_translation,
        n_optimization_steps=oc.optimization_config.n_optimization_steps,
        init_lr_t=oc.optimization_config.init_lr_t,
        init_lr_r=oc.optimization_config.init_lr_r,
        decay_t=oc.optimization_config.decay_t,
        decay_r=oc.optimization_config.decay_r, sync=True,
        top_k=c["top_k"])
    plant_faults(ctx.faults)
    h, w = c["image_size"]
    k4, ext = scenes.grasp_cameras(c["n_images"], h, w)
    state = SimpleNamespace(ctx=ctx, pipe=pipe, k4=k4, ext=ext, results={})
    for i in range(int(ctx.traffic.get("warmup_units", 0))):
        unit(state, i)
    state.results.clear()
    return state


def inputs(state, i: int):
    c = state.ctx.config
    h, w = c["image_size"]
    return (scenes.grasp_images(state.ctx.seed, i, c["n_images"], h, w),
            scenes.derived_seed(state.ctx.seed, "guesses", i))


def unit(state, i: int) -> dict:
    images, rng = inputs(state, i)
    t0 = time.perf_counter()
    result = state.pipe.infer(images, state.k4, state.ext, rng=rng)
    dt = time.perf_counter() - t0
    state.results[i] = (np.asarray(result.all_energies, np.float64),
                        np.asarray([p.matrix for p in result.poses]),
                        np.asarray(result.scores, np.float64))
    ok = bool(np.isfinite(result.all_energies).all())
    return {"service_s": dt, "latency_s": dt, "failed": not ok}


def work(state) -> dict:
    c = state.ctx.config
    opt = {"n_images": c["n_images"], "n_guesses": c["n_guesses"],
           "steps": c["steps"]}
    return {"flops": arithmetic.grasp_request_flops(c, opt),
            "steps": c["steps"]}


def finish(state) -> None:
    state.pipe = None


def check(state) -> dict:
    from benchmark.reference import grasp as ref

    ctx, c = state.ctx, state.ctx.config
    dev = ctx.device
    done = sorted(state.results)
    n = min(int(ctx.traffic.get("check_requests", 2)), len(done))
    pick = scenes.stream(ctx.seed, "sample").choice(done, size=n,
                                                    replace=False)
    torch.backends.cuda.matmul.allow_tf32 = bool(ctx.control.get(
        "reference_tf32", False))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    model = ref.GraspModel(c).to(dev)
    weights.load_into(model, weights.for_module(model, ctx.seed, dev))
    opt = {"workspace": c["workspace"], "steps": c["steps"],
           "lr_t": c["lr_t"], "lr_r": c["lr_r"], "decay_t": c["decay_t"],
           "decay_r": c["decay_r"], "clip_translation": c["clip_translation"]}
    gaps, top = [], []
    tails = {f"energy_gap_p{q}": [] for q in TAILS}
    shares = {f"energy_share_off_{t:g}": [] for t in SHARES}
    for i in pick:
        images, rng = inputs(state, int(i))
        t0, q0 = ref.initial_guesses(c["workspace"], c["n_guesses"], rng)
        out = ref.ascent(model, torch.as_tensor(images, device=dev),
                         torch.as_tensor(state.k4, device=dev),
                         torch.as_tensor(state.ext, device=dev), t0, q0, opt)
        e_ref = out["energies"].double().cpu().numpy()
        e_prog, poses, scores = state.results[int(i)]
        scale = max(float(np.std(e_ref)), 1e-30)
        gap = np.abs(e_prog - e_ref) / scale
        gaps.append(float(np.median(gap)))
        for q in TAILS:
            tails[f"energy_gap_p{q}"].append(float(np.percentile(gap, q)))
        for t in SHARES:
            shares[f"energy_share_off_{t:g}"].append(float((gap > t).mean()))
        at = ref.energies_at(model, torch.as_tensor(poses, dtype=torch.float32,
                                                    device=dev),
                             out["combined"], out["intr"], out["ext"])
        top.append(float(np.max(np.abs(scores - at.double().cpu().numpy())))
                   / scale)
        del out
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"energy_gap_median": max(gaps), "topk_gap": max(top),
            **{k: max(v) for k, v in tails.items()},
            **{k: max(v) for k, v in shares.items()},
            "checked_requests": float(n)}


# percentiles of the guesses' gaps, and the gaps (in the energies' spread)
# whose shares of the guesses are reported
TAILS = (90, 95, 99)
SHARES = (1e-3, 1e-2, 1e-1, 1.0)


def plant_faults(faults) -> None:
    """Faults the harness's tests plant in the timed path."""
    from tcnerf_torch.models import pipeline
    from tcnerf_torch.opt import pose_optimizer
    if "state_unchanged" in faults:
        harness.plant(pose_optimizer.PoseOptimizer, "optimize_pose",
                      "state_unchanged",
                      lambda fn: lambda self, st, scene, cfg=(True, True),
                      n_steps=1: (st, None))
    if "guesses_stale" in faults:
        # the last three eighths of the guesses left at their initial
        # poses, as a batched ascent that drops its last tiles would
        def make(fn):
            def stale(self, st, scene, cfg=(True, True), n_steps=1):
                out, trace = fn(self, st, scene, cfg, n_steps)
                n = st.translations.shape[1]
                cut = n - max(1, 3 * n // 8)
                out.translations[:, cut:] = st.translations[:, cut:]
                out.rotations[:, cut:] = st.rotations[:, cut:]
                return out, trace
            return stale
        harness.plant(pose_optimizer.PoseOptimizer, "optimize_pose",
                      "guesses_stale", make)
    if "answer_altered" in faults:
        def make(infer):
            def altered(self, *a, **k):
                r = infer(self, *a, **k)
                r.scores = [s + 0.05 * (abs(s) + 1.0) for s in r.scores]
                return r
            return altered
        harness.plant(pipeline.GraspPipeline, "infer", "answer_altered", make)
