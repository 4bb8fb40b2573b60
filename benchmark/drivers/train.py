"""Stage-1 training steps, back to back, as the port's trainer runs them.

Set-up writes a seeded dataset (`lib/scenes.py` `write_nerf_dataset`:
`n_scenes` x `n_perspectives` noise images on camera rings) under a
temporary directory, builds the model through the port's config and
builder, loads the benchmark's weights, makes the optimiser as the trainer
does, and feeds `nerf_train_step` from the port's generator
(`MVNeRFDataGenerator`) through `data/prefetch.py`, with a torch generator
seeded for the samples' uniforms. A unit is one step: the wait for the
prefetched batch, the step, and its loss read on the host.

The first `warmup_units` steps run in set-up through the same call and
feed; the window's first `check_steps` steps are checked with them. The
program's numbers: every step's loss; the gradient of the first step and
of the window's first step as the optimiser got them (from its first
moments: m_1 / (1 - b1), and (m - b1 m_before) / (1 - b1) around the
window's first step); each parameter's change over the warm-up steps and
over the window's checked steps. The window's are worked out on the
card, without a sync, right after the step that completes them, from
copies of the parameters and moments that set-up makes after its last
step. Faults are planted at the window's start. Once the program is freed,
the plain reference (`reference/nerf.py`, `reference/train.py`) draws the
same batches from the same files, the same uniforms from the same
generator, and takes the same steps from the same weights in float32
(TF32 off). Numbers:
  loss_gap: the largest |program - reference| / reference loss of a step;
  grad_gap, change_gap: over the leaves, the largest gap between the
      program's norm and the reference's (of a clipped gradient, of a
      change), over the larger of the reference's norm of that leaf and
      of the median leaf; the larger of the warm-up's and the window's.
      Leaves whose reference gradient is under a thousandth of the median
      leaf's are left out.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.lib import harness, port, scenes, weights
from benchmark.lib import work as arithmetic


def setup(ctx):
    c, t, dev = ctx.config, ctx.traffic, ctx.device
    from tcnerf_torch.device import resolve_device
    from tcnerf_torch.data.generators import MVNeRFDataGenerator
    from tcnerf_torch.data.loaders import load_dataset_nerf
    from tcnerf_torch.data.prefetch import prefetched_epochs
    from tcnerf_torch.models import training as T
    from tcnerf_torch.train.train_nerf import build_model

    h, w = c["image_size"]
    root = tempfile.mkdtemp(prefix="bench_nerf_")
    scenes.write_nerf_dataset(root, ctx.seed, c["n_scenes"],
                              c["n_perspectives"], h, w)
    resolve_device(dev)      # fp32 pinned, as the port's entry points do
    cfg = port.load(c)
    model = build_model(cfg, dev)
    w0 = weights.for_module(model, ctx.seed, dev)
    weights.load_into(model, w0)
    del w0
    nt = cfg.nerf_training
    train_state = T.create_train_state(model, T.make_nerf_optimizer(
        model, nerf_lr=nt.get("learning_rate", 1e-4),
        feature_lr=nt.get("feature_learning_rate", 1e-5),
        warmup_steps=nt.get("warmup_steps", 10000),
        scale_down_after=nt.get("scale_down_after", 450000)))
    data = MVNeRFDataGenerator(
        load_dataset_nerf(c["n_perspectives"], root),
        n_rays_train=c["n_rays"], batch_size=c["batch_size"],
        n_views=c["n_views"], shuffle=True,
        rng=scenes.derived_seed(ctx.seed, "batches"))
    warm = int(t.get("warmup_units", 3))
    state = SimpleNamespace(
        ctx=ctx, root=root, train=train_state, warm=warm,
        last_checked=warm + int(t.get("check_steps", 3)) - 1,
        batches=iter(prefetched_epochs(data, None, dev)),
        generator=torch.Generator(device=dev).manual_seed(
            scenes.derived_seed(ctx.seed, "draws")),
        losses=[], grad_norms=None, change_norms=None,
        window_grad=None, window_change=None, window_steps=0)
    for i in range(warm):
        unit(state, i)
        if i == 0:
            state.grad_norms = _adam_grad_norms(train_state)
    with torch.no_grad():
        w0 = weights.for_module(model, ctx.seed, dev)
        state.change_norms = {n: float((p - w0[n]).norm())
                              for n, p in model.named_parameters()}
        del w0
        state.names, params, moments, _ = _leaves(train_state)
        state.params_before = [p.clone() for p in params]
        state.moments_before = [m.clone() for m in moments]
    return state


def _leaves(train_state):
    """(names, parameters, first moments, b1) in the optimiser's order."""
    opt = train_state.optimizer.adam
    names = {id(p): n for n, p in train_state.model.named_parameters()}
    out_n, out_p, out_m, b1 = [], [], [], set()
    for group in opt.param_groups:
        for p in group["params"]:
            if "exp_avg" in opt.state.get(p, {}):
                out_n.append(names[id(p)])
                out_p.append(p)
                out_m.append(opt.state[p]["exp_avg"])
                b1.add(group["betas"][0])
    if len(b1) != 1:
        raise ValueError(f"the optimiser's groups have betas {b1}")
    return out_n, out_p, out_m, b1.pop()


@torch.no_grad()
def _window_readings(state, i: int) -> None:
    """After checked window step `i`: on the first the gradient's norms,
    on each the change's since set-up; tensors on the card, read later."""
    _, params, moments, b1 = _leaves(state.train)
    if i == state.warm:
        g = torch._foreach_add(moments, state.moments_before, alpha=-b1)
        state.window_grad = torch._foreach_norm(g)
        torch._foreach_div_(state.window_grad, 1 - b1)
        state.moments_before = None
    state.window_change = torch._foreach_norm(
        torch._foreach_sub(params, state.params_before))
    state.window_steps = i - state.warm + 1
    if i == state.last_checked:
        state.params_before = None


def _adam_grad_norms(train_state) -> dict:
    """Each leaf's first gradient, as the optimiser got it: its first
    moment after one step over (1 - b1)."""
    opt = train_state.optimizer.adam
    names = {id(p): n for n, p in train_state.model.named_parameters()}
    out = {}
    for group in opt.param_groups:
        for p in group["params"]:
            m = opt.state.get(p, {}).get("exp_avg")
            out[names[id(p)]] = (0.0 if m is None else
                                 float(m.norm()) / (1 - group["betas"][0]))
    return out


def unit(state, i: int) -> dict:
    from tcnerf_torch.models import training as T
    c = state.ctx.config
    if i == state.warm:
        plant_faults(state.ctx.faults)
    t0 = time.perf_counter()
    batch = next(state.batches)
    t1 = time.perf_counter()
    state.train, metrics = T.nerf_train_step(state.train, *batch,
                                             state.generator)
    loss = float(metrics["loss"])
    t2 = time.perf_counter()
    if state.warm <= i <= state.last_checked:
        _window_readings(state, i)
    if i <= state.last_checked:
        state.losses.append(loss)
    return {"rays": c["batch_size"] * c["n_rays"], "loss": loss,
            "wait_s": t1 - t0, "step_s": t2 - t0,
            "failed": not np.isfinite(loss)}


def work(state) -> dict:
    c = state.ctx.config
    return {"flops": arithmetic.train_step_flops(c, c["batch_size"],
                                                 c["n_rays"])}


def finish(state) -> None:
    # the window's readings, as far as its steps went
    state.window_grad = [float(x) for x in state.window_grad]
    state.window_change = [float(x) for x in state.window_change]
    state.params_before = state.moments_before = None
    state.batches.close()
    state.train = None
    state.batches = None


def check(state) -> dict:
    from benchmark.reference import nerf as ref
    from benchmark.reference import train as ref_train

    ctx, c = state.ctx, state.ctx.config
    dev = ctx.device
    try:
        tf32 = bool(ctx.control.get("reference_tf32", False))
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        model = ref.Renderer(c).to(dev)
        w0 = weights.for_module(model, ctx.seed, dev)
        weights.load_into(model, w0)
        params = dict(model.named_parameters())
        opt = ref_train.Adam(params, {"nerf": c["lr"],
                                      "feature": c["feature_lr"]},
                             c["warmup_steps"])
        feed = ref_train.batches(state.root, c["n_scenes"],
                                 c["n_perspectives"], c["batch_size"],
                                 c["n_rays"],
                                 scenes.derived_seed(ctx.seed, "batches"))
        gen = torch.Generator(device=dev).manual_seed(
            scenes.derived_seed(ctx.seed, "draws"))
        shape = (c["batch_size"], c["n_rays"], c["n_samples"])
        warm, steps = state.warm, state.warm + state.window_steps
        losses, grads_at, before = [], {}, None
        for k in range(steps):
            if k == warm:
                with torch.no_grad():
                    before = {n: p.clone() for n, p in params.items()}
                    change_warm = {n: float((p - w0[n]).norm())
                                   for n, p in params.items()}
            inputs, labels = next(feed)
            batch = (tuple(torch.as_tensor(a, device=dev) for a in inputs),
                     torch.as_tensor(labels, device=dev))
            u_c = torch.rand(shape, generator=gen, device=dev)
            u_f = torch.rand(shape, generator=gen, device=dev)
            value = ref.loss(model, batch, u_c, u_f)
            grads = torch.autograd.grad(value, list(params.values()))
            grads = dict(zip(params, grads))
            losses.append(float(value.detach()))
            if k in (0, warm):
                grads_at[k] = {n: float(g.clamp(-1, 1).norm())
                               for n, g in grads.items()}
            opt.step(grads)
            del grads, value
        with torch.no_grad():
            change_window = {n: float((p - before[n]).norm())
                             for n, p in params.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gaps = [abs(a - b) / abs(b) for a, b in zip(state.losses, losses)]
    window_grad = dict.fromkeys(grads_at[warm], 0.0)
    window_grad.update(zip(state.names, state.window_grad))
    window_change = dict.fromkeys(change_window, 0.0)
    window_change.update(zip(state.names, state.window_change))
    parts = {
        "warmup": (state.grad_norms, state.change_norms, grads_at[0],
                   change_warm),
        "window": (window_grad, window_change, grads_at[warm],
                   change_window)}
    out = {"loss_gap": max(gaps), "window_steps": float(state.window_steps)}
    left_out = 0
    for part, (grad_p, change_p, grad_r, change_r) in parts.items():
        floor = 1e-3 * float(np.median(list(grad_r.values())))
        kept = [n for n, g in grad_r.items() if g >= floor]
        left_out = max(left_out, len(grad_r) - len(kept))
        grad = leaf_gaps(grad_p, grad_r, kept)
        moved = leaf_gaps(change_p, change_r, kept)
        out[f"grad_gap.{part}"] = max(grad.values())
        out[f"change_gap.{part}"] = max(moved.values())
        out[f"grad_gap_median_leaf.{part}"] = float(
            np.median(list(grad.values())))
        out[f"change_gap_median_leaf.{part}"] = float(
            np.median(list(moved.values())))
        print(f"train check, {part}: worst gradient leaf "
              f"{max(grad, key=grad.get)}, worst change leaf "
              f"{max(moved, key=moved.get)}", file=sys.stderr)
    out["grad_gap"] = max(out["grad_gap.warmup"], out["grad_gap.window"])
    out["change_gap"] = max(out["change_gap.warmup"],
                            out["change_gap.window"])
    out["leaves_left_out"] = float(left_out)
    out.update({f"loss_gap_step{k + 1}": g for k, g in enumerate(gaps)})
    return out


def cleanup(state) -> None:
    shutil.rmtree(state.root, ignore_errors=True)


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """Per leaf |got - want| over the larger of want and the median
    leaf's want."""
    med = float(np.median([want[n] for n in names]))
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in names}


def plant_faults(faults) -> None:
    """Faults the harness's tests plant in the timed path."""
    from tcnerf_torch.models import training as T
    if "state_unchanged" in faults:
        harness.plant(T.NerfOptimizer, "step", "state_unchanged",
                      lambda fn: lambda self: setattr(self, "count",
                                                      self.count + 1))
    if "half_batch" in faults:
        def make(loss):
            def half(model, inputs, labels, u_c, u_f, ray_chunk=None):
                r = inputs[0].shape[1] // 2
                inputs = tuple(x[:, :r] if k < 2 else x
                               for k, x in enumerate(inputs))
                return loss(model, inputs, labels[:, :r], u_c[:, :r],
                            u_f[:, :r], ray_chunk)
            return half
        harness.plant(T, "nerf_loss", "half_batch", make)
    if "answer_altered" in faults:
        def make(step):
            def altered(*a, **k):
                s, m = step(*a, **k)
                return s, {"loss": m["loss"] * 1.01}
            return altered
        harness.plant(T, "nerf_train_step", "answer_altered", make)
