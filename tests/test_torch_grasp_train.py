"""tcnerf_torch's grasp training steps against the JAX package on the CPU:
the losses, `grasp_train_step` and the second-order `delta_ngf_train_step`
(tcnerf_torch/models/grasp_training.py).

The models are tests/test_torch_grasp.py's: the tiny goal model (48x64
sources, n_features 32, 3 5-d poses, 2 blocks, hidden 32, ViT dim 32) and
the CLIP-tiny v4 language model, their flax trees filled from a numpy seed
and carried to the port through `from_flax`. The steps are compared in
f64 under `jax.enable_x64`: Adam's first step is a sign step, and the
energy's f32 gradient is only piecewise smooth (ROADMAP Queue C).
`jax.nn.dot_product_attention` takes its softmax in f32 whatever the
inputs' dtype, so the JAX side runs with an f64 attention in its place
(`_f64_attention`: the same logits, scale and mask, the softmax in f64);
the port's f64 attention is f64 throughout. The JAX
steps run once per case and are cached for the module; their optimizer is
optax's own chain behind a transformation that records the gradients it
is given, so the JAX gradients are held before clipping, as the port's
`grasp_gradients` / `delta_ngf_gradients` return them.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_fusion import _fill
from test_torch_grasp import GOAL, H, LANGUAGE, W, WORKSPACE
from tcnerf.clip import tokenizer as jtok
from tcnerf.core import se3 as jse3
from tcnerf.models import grasp as jgrasp
from tcnerf.models import grasp_training as JGT
from tcnerf_torch.data.synthetic import camera_ring
from tcnerf_torch.models import grasp, grasp_training as GT
from tcnerf_torch.params import from_flax

B = 2            # samples per goal batch (one per delta-NGF batch)
N = 6            # landscape poses per sample
LR = 1e-4
PROMPT = "grasp the red ball"

# ------------------------------------------------------------------ losses


def _loss_inputs(rng):
    labels = np.zeros((3, 7), np.float32)
    labels[np.arange(3), rng.integers(0, 7, 3)] = 1.0
    logits = rng.normal(size=(3, 7)).astype(np.float32) * 2
    probs = np.asarray(jax.nn.softmax(logits), np.float32)
    a = rng.normal(size=(3, 5, 4)).astype(np.float32)
    b = rng.normal(size=(3, 5, 4)).astype(np.float32)
    return labels, logits, probs, a, b


LOSS_CASES = ["cross_entropy", "kl_mean", "kl_sum", "cosine",
              "landscape_kl_sum"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_matches_jax(case):
    """Each loss of both packages on the same f32 inputs: 1e-6 relative
    (`landscape_loss_fn` picks the same loss and softmax flag)."""
    labels, logits, probs, a, b = _loss_inputs(np.random.default_rng(5))
    t = torch.as_tensor
    if case == "cross_entropy":
        got = GT.categorical_crossentropy_logits(t(labels), t(logits))
        want = JGT.categorical_crossentropy_logits(labels, logits)
    elif case.startswith("kl_"):
        red = case[3:]
        got = GT.kl_divergence(t(labels), t(probs), reduction=red)
        want = JGT.kl_divergence(labels, probs, reduction=red)
    elif case == "cosine":
        got = GT.cosine_similarity_loss(t(a), t(b))
        want = JGT.cosine_similarity_loss(a, b)
    else:
        fn, soft = GT.landscape_loss_fn("kl_divergence", "sum")
        jfn, jsoft = JGT.landscape_loss_fn("kl_divergence", "sum")
        assert soft and jsoft
        got, want = fn(t(labels), t(probs)), jfn(labels, probs)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        GT.landscape_loss_fn("hinge")


# ------------------------------------------------------------------ models


def _attention64(query, key, value, bias=None, mask=None, **kw):
    """jax.nn.dot_product_attention([B, T, N, H] q, k, v; a boolean mask)
    with the softmax in the inputs' dtype."""
    assert bias is None and not kw
    logits = jnp.einsum("BTNH,BSNH->BNTS", query, key)
    logits = logits * jnp.asarray(1.0 / np.sqrt(query.shape[-1]),
                                  logits.dtype)
    if mask is not None:
        logits = jnp.where(mask, logits,
                           -0.7 * jnp.finfo(logits.dtype).max)
    probs = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("BNTS,BSNH->BTNH", probs, value)


@contextlib.contextmanager
def _f64_attention():
    """x64 on, and the f64 attention in place of JAX's."""
    original = jax.nn.dot_product_attention
    jax.nn.dot_product_attention = _attention64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jax.nn.dot_product_attention = original


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _trees():
    """The filled flax param trees of the goal and language models."""
    out = {}
    ring = camera_ring(B, height=H, width=W)
    for kind, kw in (("goal", GOAL), ("language", LANGUAGE)):
        fm = jgrasp.GraspEBM(**kw)
        args = [jnp.tile(jnp.eye(4), (B, 2, 1, 1)),
                jnp.zeros((B, 1, H, W, 3)), jnp.zeros((B, 1, 4, 4)),
                jnp.zeros((B, 1, 4, 4))]
        if kw.get("fusion"):
            args.append(jnp.zeros((B, 77), jnp.int32))
        shapes = jax.eval_shape(functools.partial(fm.init, method="init_all"),
                                jax.random.PRNGKey(0), *args)["params"]
        out[kind] = _fill(shapes, np.random.default_rng(3))
    assert len(ring) == B
    return out


def _batch_scene(rng, b):
    """b samples of one view each (views of a ring): images
    [b, 1, H, W, 3], intrinsics, inverse extrinsics [b, 1, 4, 4], f64."""
    cfgs = camera_ring(B, height=H, width=W)[:b]
    k4 = np.tile(np.eye(4), (b, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in cfgs]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in cfgs])
    images = rng.uniform(size=(b, 1, H, W, 3))
    return images, k4[:, None], ext[:, None]


def _pose_params(rng, b, n, rep):
    lo = [a for a, _ in WORKSPACE]
    hi = [b for _, b in WORKSPACE]
    t = rng.uniform(lo, hi, (b, n, 3))
    r = rng.normal(size=(b, n, 4 if rep == "quaternion" else 6))
    return t, r


def _one_hot(b, n):
    y = np.zeros((b, n))
    y[:, 0] = 1.0
    return y


def _capture():
    """An optax transformation that passes the gradients on unchanged and
    keeps the last ones in its state."""
    def init(params):
        return {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return updates, {"grads": updates}

    return optax.GradientTransformation(init, update)


def _jax_state(fm, params, trainable):
    tx = optax.chain(_capture(), optax.clip(1.0), optax.adam(LR))
    return JGT.GraspTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init({c: params[c] for c in trainable}), tx=tx,
        apply_fn=fm.apply, trainable=tuple(trainable))


def _port(kw, params, trainable):
    m = grasp.GraspEBM(**kw).double()
    m.load_state_dict(from_flax(params, np.float64), strict=True)
    return GT.create_grasp_train_state(m, LR, trainable)


def _as_port(grads):
    """A JAX gradient tree (top-level components) as port names -> f64."""
    return {k: v.numpy() for k, v in from_flax(grads, np.float64).items()}


def _close64(got, want, rtol, what, floor=0.0):
    """max |got - want| <= rtol x max(max |want|, floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor, 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _hold_grads(state, grads, jgrads, rtol=1e-9):
    """The port's gradients against the JAX tree, tensor by tensor: each
    within rtol x its max |jax|, a max floored at 1e-3 x the largest
    gradient of all (a gradient that is zero in exact arithmetic, such as
    the cross-entropy's on the energy's output bias, is rounding in
    both); every trainable tensor present."""
    want = _as_port(jgrads)
    assert sorted(want) == sorted(state.names)
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for name, g in zip(state.names, grads):
        _close64(g.numpy(), want[name], rtol, name, floor)


# ------------------------------------------------------------ goal step

GOAL_CASES = [("cross_entropy", "mean"), ("kl_divergence", "mean"),
              ("kl_divergence", "sum")]


def _goal_batch():
    rng = np.random.default_rng(11)
    images, intr, ext = _batch_scene(rng, B)
    t, r = _pose_params(rng, B, N, "quaternion")
    poses = np.asarray(jse3.pose_to_matrix(t, r), np.float64)
    return [poses, images, intr, ext], _one_hot(B, N)


@functools.lru_cache(maxsize=None)
def _jax_goal(loss, reduction):
    """Three JAX goal steps in f64: per step the loss and the gradients,
    then the readout."""
    inputs, labels = _goal_batch()
    with _f64_attention():
        params = jax.tree_util.tree_map(jnp.asarray, _f64(_trees()["goal"]))
        state = _jax_state(jgrasp.GraspEBM(**GOAL), params,
                           ("grasp_readout",))
        steps = []
        for _ in range(3):
            state, m = JGT.grasp_train_step(
                state, [jnp.asarray(x) for x in inputs], jnp.asarray(labels),
                loss, reduction)
            steps.append((float(m["loss"]),
                          jax.device_get(state.opt_state[0]["grads"])))
        readout = jax.device_get({"grasp_readout":
                                  state.params["grasp_readout"]})
    return steps, readout


@pytest.mark.parametrize("loss,reduction", GOAL_CASES)
def test_grasp_train_step_matches_jax(loss, reduction):
    """Three goal steps in f64: each step's loss and readout gradients
    (before clipping) 1e-9 relative; the readout after the three Adam
    steps within 1e-10 absolute, leaving out the entries whose gradient
    was below 1e-12 x its tensor's max in either package at some step
    (Adam's first step is a sign step there; they are counted); every
    backbone parameter bit-identical and without a gradient."""
    steps, readout = _jax_goal(loss, reduction)
    inputs, labels = _goal_batch()
    state = _port(GOAL, _trees()["goal"], ("grasp_readout",))
    model = state.model
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not n.startswith("grasp_readout")}
    t = [torch.as_tensor(x) for x in inputs]
    tiny = {n: np.zeros(p.shape, bool) for n, p in zip(state.names,
                                                        state.params)}
    for want_loss, jgrads in steps:
        metrics, grads = GT.grasp_gradients(state, t, torch.as_tensor(labels),
                                            loss, reduction)
        _close64(float(metrics["loss"]), want_loss, 1e-9, "loss")
        _hold_grads(state, grads, jgrads)
        want = _as_port(jgrads)
        for name, g in zip(state.names, grads):
            for x in (g.numpy(), want[name]):
                tiny[name] |= np.abs(x) < 1e-12 * np.abs(x).max()
        state.optimizer.step(grads)
        state.step += 1
    assert state.step == 3
    n_tiny = sum(int(m.sum()) for m in tiny.values())
    n_all = sum(m.size for m in tiny.values())
    assert n_tiny < 0.01 * n_all, (n_tiny, n_all)
    want = _as_port(readout)
    for name, p in zip(state.names, state.params):
        keep = ~tiny[name]
        np.testing.assert_allclose(p.detach().numpy()[keep],
                                   want[name][keep], rtol=0, atol=1e-10,
                                   err_msg=name)
    for n, p in model.named_parameters():
        if n in frozen:
            assert p.grad is None and not p.requires_grad, n
            assert torch.equal(p.detach(), frozen[n]), n


# ------------------------------------------------------ delta-NGF step

# (name, model kind, rotation, loss, use_tokens, train_fusion)
DELTA_CASES = [("quaternion", "goal", "quaternion", "cross_entropy", False,
                False),
               ("6d", "goal", "6d", "kl_divergence", False, False),
               ("tokens_v4", "language", "6d", "kl_divergence", True, False),
               ("train_fusion", "language", "quaternion", "kl_divergence",
                True, True)]


def _kw(kind, train_fusion):
    kw = dict(GOAL if kind == "goal" else LANGUAGE)
    if kind == "goal":    # the delta-NGF readout flavour
        kw.update(readout_kernel_init="he_normal")
    if train_fusion:      # as build_grasp_model sets them
        kw.update(corner_gather=False, remat_fusion=True)
    return kw


def _delta_batch(rep, use_tokens):
    rng = np.random.default_rng(13)
    images, intr, ext = _batch_scene(rng, 1)
    l_t, l_r = _pose_params(rng, 1, N, rep)
    g_t, g_r = _pose_params(rng, 1, 4, rep)
    d_t = rng.normal(size=g_t.shape) * 0.01
    d_r = rng.normal(size=g_r.shape) * 0.1
    inputs = [l_t, l_r, g_t, g_r, images, intr, ext]
    if use_tokens:
        inputs.append(np.asarray(jtok.tokenize(PROMPT), np.int32))
    return inputs, [_one_hot(1, N), d_t, d_r]


def _trainable(train_fusion):
    return ("grasp_readout",) + (("combine_clip_visual",) if train_fusion
                                 else ())


@functools.lru_cache(maxsize=None)
def _jax_delta(name):
    _, kind, rep, loss, use_tokens, train_fusion = next(
        c for c in DELTA_CASES if c[0] == name)
    inputs, labels = _delta_batch(rep, use_tokens)
    with _f64_attention():
        params = jax.tree_util.tree_map(jnp.asarray, _f64(_trees()[kind]))
        state = _jax_state(jgrasp.GraspEBM(**_kw(kind, train_fusion)),
                           params, _trainable(train_fusion))
        state, metrics = JGT.delta_ngf_train_step(
            state, [jnp.asarray(x) for x in inputs],
            [jnp.asarray(x) for x in labels], loss, rep, use_tokens)
        return ({k: float(v) for k, v in metrics.items()},
                jax.device_get(state.opt_state[0]["grads"]))


@pytest.mark.parametrize("case", DELTA_CASES, ids=lambda c: c[0])
def test_delta_ngf_train_step_matches_jax(case):
    """One delta-NGF step in f64 (the landscape loss plus the cosine losses
    on the energy's pose gradient, backpropagated through that gradient):
    the four metrics and the trainable gradients before clipping, 1e-9
    relative; the readout alone, or with `train_fusion` the v4 decoder
    too (under remat, the 4-tap gather); then the port's step moves
    exactly the trainable parameters."""
    name, kind, rep, loss, use_tokens, train_fusion = case
    want_metrics, jgrads = _jax_delta(name)
    inputs, labels = _delta_batch(rep, use_tokens)
    state = _port(_kw(kind, train_fusion), _trees()[kind],
                  _trainable(train_fusion))
    t = [torch.as_tensor(x) for x in inputs]
    lab = [torch.as_tensor(x) for x in labels]
    metrics, grads = GT.delta_ngf_gradients(state, t, lab, loss, rep,
                                            use_tokens)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in want_metrics.items():
        _close64(float(metrics[k]), v, 1e-9, k)
    _hold_grads(state, grads, jgrads)
    if train_fusion:
        assert any(n.startswith("combine_clip_visual.") for n in state.names)
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    GT.delta_ngf_train_step(state, t, lab, loss, rep, use_tokens)
    moved = {n for n, p in state.model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved == {n for n, g in zip(state.names, grads)
                     if bool((g != 0).any())}


def test_create_grasp_train_state_freezes_the_rest():
    """Only the trainable components require a gradient; an unknown
    component raises."""
    m = grasp.GraspEBM(**GOAL)
    state = GT.create_grasp_train_state(m)
    assert state.names and all(n.startswith("grasp_readout.")
                               for n in state.names)
    assert {n for n, p in m.named_parameters() if p.requires_grad} == set(
        state.names)
    with pytest.raises(ValueError, match="combine_clip_visual"):
        GT.create_grasp_train_state(m, trainable=("grasp_readout",
                                                  "combine_clip_visual"))


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_resize_f64_matches_jax_x64(method):
    """nn/layers.resize on f64 inputs computes its weights in f64, as
    jax.image.resize does under x64 (shrinking 48x64 -> 32x32 and growing
    12x16 -> 24x32): within 1e-13; f32 inputs keep f32 weights."""
    from tcnerf_torch.nn.layers import resize
    rng = np.random.default_rng(0)
    for shape, size in (((2, 48, 64, 3), (32, 32)), ((1, 12, 16, 5),
                                                      (24, 32))):
        x = rng.normal(size=shape)
        with jax.enable_x64(True):
            want = np.asarray(jax.image.resize(
                jnp.asarray(x), shape[:1] + size + shape[-1:], method=method))
        got = resize(torch.as_tensor(x), size, method).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
        x32 = x.astype(np.float32)
        want32 = np.asarray(jax.image.resize(
            jnp.asarray(x32), shape[:1] + size + shape[-1:], method=method))
        got32 = resize(torch.as_tensor(x32), size, method).numpy()
        assert got32.dtype == np.float32
        np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-5)
