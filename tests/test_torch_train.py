"""tcnerf_torch training (K1' `resmlp_rows_diff`, schedules, optimizer, train
step, config, data) against the JAX package on the CPU, on a tiny 1-view
model: hidden 128 (K1' on the path), 2 blocks, ViT dim 32 / 2 heads /
32^2 / hooks 1-4, 16x24 images, 8 samples, corner_gather off and remat on
as the trainer runs. Params come from flax `init` through `from_flax`;
sampling draws are JAX's, captured with `make_rng`. Each test names its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcnerf.data import generators as jgen
from tcnerf.data import loaders as jload
from tcnerf.data import synthetic as jsyn
from tcnerf.models import training as jtrain
from tcnerf.models.renderer import MVNeRFRenderer as FlaxRenderer
from tcnerf.opt import schedules as jsched
from tcnerf.ops.pallas.resmlp import resmlp_rows_diff as jresmlp_rows_diff
from tcnerf.train import config as jconfig
from tcnerf.utils import native
from tcnerf_torch.core.rays import get_specific_rays
from tcnerf_torch.data import generators, loaders, synthetic
from tcnerf_torch.models import training
from tcnerf_torch.models.renderer import MVNeRFRenderer
from tcnerf_torch.nn.mlp import MVResNetMLPEmbedding
from tcnerf_torch.ops.resmlp import resmlp_rows_diff
from tcnerf_torch.opt import schedules
from tcnerf_torch.params import from_flax
from tcnerf_torch.train import config, train_nerf

H, W, S = 16, 24, 8
CFG = dict(n_views=1, n_samples=S, n_features=8, near=0.3, far=1.3,
           original_image_size=(H, W), fusion="without", n_blocks=2,
           hidden_size=128, vit_size=(32, 32), vit_dim=32, vit_heads=2,
           vit_hooks=(1, 2, 3, 4), corner_gather=False, remat=True)
HID = 128


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(got, want, rtol, atol_scale):
    """|got - want| <= rtol |want| + atol_scale * max |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()))


def _draw(module, b, r, s):
    """The two `sampling` draws render_rays makes, in its order."""
    k_c = module.make_rng("sampling")
    k_f = module.make_rng("sampling")
    return (jax.random.uniform(k_c, (b, r, s)),
            jax.random.uniform(k_f, (b, r, s)))


def _batch(rng, b, r):
    """A [B, R] ray batch through target pixels of a 2-camera arc, so the
    samples project into the source view, and random target colours."""
    src_cfg, tgt_cfg = synthetic.camera_ring(2, height=H, width=W,
                                             azimuth_span=0.6)
    k4 = np.eye(4, dtype=np.float32)
    k4[:3, :3] = src_cfg["intrinsics"].reshape(3, 3)
    ext = np.linalg.inv(src_cfg["pose"]).astype(np.float32)
    ro, rd = zip(*[get_specific_rays(
        rng.uniform(0, W - 1, r), rng.uniform(0, H - 1, r), tgt_cfg["pose"],
        tgt_cfg["intrinsics"].reshape(3, 3)) for _ in range(b)])
    inputs = (np.stack(ro).astype(np.float32), np.stack(rd).astype(np.float32),
              rng.uniform(size=(b, 1, H, W, 3)).astype(np.float32),
              np.tile(k4, (b, 1, 1, 1)), np.tile(ext, (b, 1, 1, 1)))
    return inputs, rng.uniform(size=(b, r, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def flax_model():
    rng = np.random.default_rng(0)
    inputs, _ = _batch(rng, 1, 8)
    fm = FlaxRenderer(**CFG)
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(fm.init)({"params": jax.random.PRNGKey(0),
                                      "sampling": jax.random.PRNGKey(1)},
                                     tuple(jnp.asarray(x) for x in inputs))
    params = jax.device_get(variables["params"])
    return fm, params, from_flax(params)


def _port(state, **kw):
    m = MVNeRFRenderer(**{**CFG, **kw})
    m.load_state_dict(state, strict=True)
    return m


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


# ------------------------------------------------------------------ K1'

def _chain(rng, d_in, n_blocks, out_dim):
    flat = [] if d_in is None else [rng.normal(size=(d_in, HID)) / np.sqrt(d_in),
                                    rng.normal(size=(HID,)) * 0.1]
    for _ in range(n_blocks):
        flat += [rng.normal(size=(HID, HID)) * 0.09,
                 rng.normal(size=(HID,)) * 0.1,
                 rng.normal(size=(HID, HID)) * 0.09,
                 rng.normal(size=(HID,)) * 0.1]
    if out_dim:
        flat += [rng.normal(size=(HID, out_dim)) * 0.09,
                 rng.normal(size=(out_dim,)) * 0.1]
    return [w.astype(np.float32) for w in flat]


@pytest.mark.parametrize("skip_input,readout", [(False, False), (True, False),
                                                (False, True)])
def test_resmlp_rows_diff_matches_jax(skip_input, readout):
    """K1' value and gradients (x and every weight) vs the JAX custom_vjp
    with the Pallas forward in interpret mode: value rtol 1e-4, gradients
    rtol 5e-4 / atol 5e-5, the JAX suite's bars (test_kernels.py:428-434)."""
    rng = np.random.default_rng(1)
    d_in, n_blocks = (HID if skip_input else 64), 2
    flat = _chain(rng, None if skip_input else d_in, n_blocks,
                  4 if readout else 0)
    x = rng.normal(size=(200, d_in)).astype(np.float32)
    tgt = rng.normal(size=(200, 4 if readout else HID)).astype(np.float32)

    def jloss(x_, w_):
        out = jresmlp_rows_diff(x_, w_, n_blocks, readout, "relu", 128,
                                skip_input, True)
        return jnp.mean((out - tgt) ** 2)

    with jax.default_matmul_precision("highest"):
        v_j, (dx_j, dw_j) = jax.value_and_grad(jloss, (0, 1))(
            jnp.asarray(x), tuple(jnp.asarray(w) for w in flat))
    xt = _t(x).requires_grad_()
    wt = [_t(w).requires_grad_() for w in flat]
    out = resmlp_rows_diff(xt, wt, n_blocks, readout=readout,
                           skip_input=skip_input)
    loss = torch.mean((out - _t(tgt)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(v_j), rtol=1e-4)
    for got, want in zip([xt.grad] + [w.grad for w in wt],
                         [dx_j] + list(dw_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                                   atol=5e-5)


def test_embedding_pallas_grads_match_plain():
    """MVResNetMLPEmbedding(use_pallas=True) gives every parameter the
    gradient of the plain chain (CPU: K1' is the plain chain both ways):
    rtol 1e-5 / atol 1e-6, f32 summation order only."""
    rng = np.random.default_rng(2)
    pos, dirs = _t(rng.normal(size=(2, 4, 8, 3))), _t(rng.normal(size=(2, 4, 8, 3)))
    feats = _t(rng.normal(size=(2, 4, 8, 16)))
    grads = []
    for use_pallas in (False, True):
        torch.manual_seed(0)
        m = MVResNetMLPEmbedding(16, n_blocks=2, hidden_size=HID, n_views=2,
                                 embed_direction_vector=True,
                                 use_pallas=use_pallas)
        for p in m.parameters():
            torch.nn.init.normal_(p, std=0.1)
        torch.mean(m(pos, dirs, feats) ** 2).backward()
        grads.append(_grads(m))
    for name, want in grads[0].items():
        assert grads[1][name] is not None and bool(want.abs().sum() > 0)
        _close(grads[1][name], want, 1e-5, 1e-6)


def test_pack_is_rebuilt_once_per_optimizer_step():
    """An optimizer step moves every parameter's version: the embedding's
    kernel pack is rebuilt once on the next call, and reused after."""
    m = MVResNetMLPEmbedding(16, n_blocks=2, hidden_size=HID, n_views=1,
                             use_pallas=True)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    opt = training.NerfOptimizer(m, nerf_lr=1e-2, warmup_steps=0)

    def packs():
        return m._chain_packs([m._chain_flat(m.feature_blocks, torch.float32),
                               m._chain_flat(m.fusion_blocks, torch.float32)],
                              torch.float32)

    first = packs()
    assert packs() is first and m.pack_builds == 1
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert packs() is not first and m.pack_builds == 2
    packs()
    assert m.pack_builds == 2


# ---------------------------------------------------- schedules, optimizer

@pytest.mark.parametrize("warmup,scale_down", [(10, 20), (0, 5), (3, 3)])
def test_warmup_constant_schedule_matches_jax(warmup, scale_down):
    """Bit-equal to the JAX schedule (both float32) at steps 0, 1, warmup,
    warmup + 1, scale_down_after and + 1."""
    want = jsched.warmup_constant_schedule(1e-4, warmup, scale_down)
    got = schedules.warmup_constant_schedule(1e-4, warmup, scale_down)
    for step in (0, 1, warmup, warmup + 1, scale_down, scale_down + 1):
        assert got(step) == float(want(step)), step


def test_exponential_decay_matches_jax():
    """rtol 1e-6: float32 powers (one ulp)."""
    want = jsched.exponential_decay(1e-3, 0.5, 7)
    got = schedules.exponential_decay(1e-3, 0.5, 7)
    for step in (0, 1, 6, 7, 8, 100):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_param_groups_match_jax(flax_model):
    _, params, state = flax_model
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        want[path[0].key] = jtrain.param_group(path)
    got = {name.split(".")[0]: training.param_group(name) for name in state}
    assert got == want
    assert set(want.values()) == {"nerf", "feature"}


def test_optimizer_matches_optax(flax_model):
    """3 updates from identical numpy gradients (some beyond +-1, so the
    clip acts) through optax's multi_transform and the port's optimizer:
    parameters rtol 1e-5 / atol 1e-6 (Adam's f32 rounding order). The first
    update has learning rate 0 in both."""
    _, params, state = flax_model
    tx = jtrain.make_nerf_optimizer(nerf_lr=1e-2, feature_lr=1e-3,
                                    warmup_steps=2, scale_down_after=100)
    m = _port(state)
    opt = training.make_nerf_optimizer(m, nerf_lr=1e-2, feature_lr=1e-3,
                                       warmup_steps=2, scale_down_after=100)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(3)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                                  * 2.0), jparams)
        updates, opt_state = update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = from_flax(jax.device_get(grads))
        for name, p in m.named_parameters():
            p.grad = tgrads[name].clone()
        opt.step()
        want = from_flax(jax.device_get(jparams))
        for name, p in m.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        if step == 0:
            for name, p in m.named_parameters():
                assert torch.equal(p.detach(), state[name]), name


# ------------------------------------------------------------ train step

def _jax_loss(fm, params, inputs, labels, key, grad):
    def loss_fn(p):
        rgb, _, fine_rgb, _, aux = fm.apply({"params": p}, inputs,
                                            rngs={"sampling": key})
        return jtrain.mse(labels, rgb) + jtrain.mse(labels, fine_rgb) + aux

    fn = jax.value_and_grad(loss_fn) if grad else loss_fn
    out = jax.jit(fn)(params)
    draws = fm.apply({"params": params}, labels.shape[0], labels.shape[1], S,
                     method=_draw, rngs={"sampling": key})
    return jax.device_get(out), jax.device_get(draws)


@pytest.fixture(scope="module")
def jax_step(flax_model):
    """The JAX loss of one [2, 16] batch in f32 (HIGHEST), and its loss and
    gradients in f64."""
    fm, params, _ = flax_model
    inputs, labels = _batch(np.random.default_rng(4), 2, 16)
    key = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        loss32, draws32 = _jax_loss(fm, params, tuple(map(jnp.asarray, inputs)),
                                    jnp.asarray(labels), key, False)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        (loss64, grads64), draws64 = _jax_loss(
            fm, p64, tuple(jnp.asarray(x, jnp.float64) for x in inputs),
            jnp.asarray(labels, jnp.float64), key, True)
    return dict(inputs=inputs, labels=labels, loss32=float(loss32),
                draws32=draws32, loss64=float(loss64),
                grads64={k: v.double() for k, v in from_flax(grads64).items()},
                draws64=draws64)


@pytest.mark.parametrize("pallas_mlp", [False, True])
def test_train_loss_and_grads_match_jax(flax_model, jax_step, pallas_mlp):
    """The unchunked loss vs the JAX loss, same params and draws: f32 at
    HIGHEST precision, rtol 1e-3. Loss and every parameter's gradient vs
    jax.value_and_grad of the JAX loss in f64: rtol 1e-3 / atol 1e-3 x max
    |grad| of the tensor (+1e-9 for the gradients that are zero in exact
    arithmetic: biases before a batch-statistics norm, attention key
    biases). The gradients are compared in f64 because in f32 they are
    ill-conditioned: the fine loss reaches the coarse weights through the
    inverse-CDF resampling, whose slope divides by CDF gaps down to 1e-5,
    so f32 rounding alone moves them by more than 1e-3 (on the card a
    bf16 rounding of the chain weights moves a full-width step's gradient
    by ~3%, chip_smoke.py), and no f32 implementation can hold 1e-3
    against another. The
    flax side runs pallas_mlp=False (its kernel has no interpret switch
    there); K1' is held to the JAX K1' in interpret mode above."""
    _, _, state = flax_model
    st = jax_step
    m = _port(state, pallas_mlp=pallas_mlp)
    with torch.no_grad():
        loss32 = training.nerf_loss(m, tuple(map(_t, st["inputs"])),
                                    _t(st["labels"]),
                                    *map(_t, st["draws32"]))
    np.testing.assert_allclose(float(loss32), st["loss32"], rtol=1e-3)
    m = m.double()
    loss = training.nerf_loss(
        m, tuple(_t(x).double() for x in st["inputs"]),
        _t(st["labels"]).double(),
        *(torch.as_tensor(np.asarray(u)) for u in st["draws64"]))
    loss.backward()
    np.testing.assert_allclose(float(loss), st["loss64"], rtol=1e-3)
    for name, grad in _grads(m).items():
        assert grad is not None and torch.isfinite(grad).all(), name
        want = st["grads64"][name].numpy()
        np.testing.assert_allclose(
            grad.numpy(), want, rtol=1e-3,
            atol=1e-3 * float(np.abs(want).max()) + 1e-9, err_msg=name)


def _port_loss_grads(state, inputs, labels, draws, dtype=torch.float32,
                     **kw):
    m = _port(state, **{k: v for k, v in kw.items() if k != "ray_chunk"})
    m = m.to(dtype)
    loss = training.nerf_loss(m, tuple(x.to(dtype) for x in inputs),
                              labels.to(dtype), *(u.to(dtype) for u in draws),
                              ray_chunk=kw.get("ray_chunk"))
    loss.backward()
    return float(loss), _grads(m)


@pytest.mark.parametrize("pallas_mlp", [False, True])
def test_chunked_step_matches_unchunked(flax_model, pallas_mlp):
    """Checkpointed 8-ray chunks (draws sliced per chunk, taken before the
    chunks) vs the whole batch at once, same draws, in f64: loss rtol 1e-5,
    gradients rtol 1e-4 / atol 1e-4 x max |grad| + 1e-9 (summation order
    only; in f32 the resampling's ill-conditioned slope, see
    test_train_loss_and_grads_match_jax, turns the chunks' other rounding
    into ~1e-3 differences)."""
    _, _, state = flax_model
    rng = np.random.default_rng(6)
    inputs, labels = _batch(rng, 1, 32)
    inputs, labels = tuple(_t(x) for x in inputs), _t(labels)
    draws = (_t(rng.uniform(size=(1, 32, S))), _t(rng.uniform(size=(1, 32, S))))
    kw = dict(pallas_mlp=pallas_mlp, dtype=torch.float64)
    whole = _port_loss_grads(state, inputs, labels, draws, **kw)
    chunked = _port_loss_grads(state, inputs, labels, draws, ray_chunk=8,
                               **kw)
    np.testing.assert_allclose(chunked[0], whole[0], rtol=1e-5)
    for name, want in whole[1].items():
        want = want.numpy()
        np.testing.assert_allclose(
            chunked[1][name].numpy(), want, rtol=1e-4,
            atol=1e-4 * float(np.abs(want).max()) + 1e-9, err_msg=name)


def test_remat_does_not_change_the_step(flax_model):
    """remat recomputes the embeddings and the encoder in the backward: the
    same loss and gradients as without it, in f64 at the bars of the
    chunked test (loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-4 x max
    |grad| + 1e-9). Not bit for bit: CPU kernels do not promise the same
    bits from run to run, and the resampling amplifies a last-bit
    difference."""
    _, _, state = flax_model
    rng = np.random.default_rng(7)
    inputs, labels = _batch(rng, 1, 8)
    inputs, labels = tuple(_t(x) for x in inputs), _t(labels)
    draws = (_t(rng.uniform(size=(1, 8, S))), _t(rng.uniform(size=(1, 8, S))))
    kw = dict(dtype=torch.float64)
    on = _port_loss_grads(state, inputs, labels, draws, remat=True, **kw)
    off = _port_loss_grads(state, inputs, labels, draws, remat=False, **kw)
    np.testing.assert_allclose(on[0], off[0], rtol=1e-5)
    for name, want in off[1].items():
        want = want.numpy()
        np.testing.assert_allclose(
            on[1][name].numpy(), want, rtol=1e-4,
            atol=1e-4 * float(np.abs(want).max()) + 1e-9, err_msg=name)


def test_train_step_draws_once_and_updates(flax_model):
    """nerf_train_step draws from the generator before the chunks, so two
    runs from one seed give the same losses (rtol 1e-6; other draws move
    them by ~1e-2); the step counter and the
    parameters move (lr 0 on the first update, the full rate on the second
    with a 1-step warmup)."""
    _, _, state = flax_model
    inputs, labels = _batch(np.random.default_rng(8), 1, 16)
    inputs, labels = tuple(_t(x) for x in inputs), _t(labels)
    losses = []
    for _ in range(2):
        m = _port(state)
        ts = training.create_train_state(
            m, training.make_nerf_optimizer(m, warmup_steps=1))
        gen = torch.Generator().manual_seed(0)
        _, met = training.nerf_train_step(ts, inputs, labels, gen,
                                          ray_chunk=8)
        before = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
        _, met2 = training.nerf_train_step(ts, inputs, labels, gen,
                                           ray_chunk=8)
        losses.append((float(met["loss"]), float(met2["loss"])))
        assert ts.step == 2 and np.isfinite(losses[-1]).all()
        for n, p in ts.model.named_parameters():
            # a gradient that is zero in exact arithmetic (a bias before a
            # batch-statistics norm) may come out exactly zero: no update
            if p.grad.abs().max() > 0:
                assert not torch.equal(p.detach(), before[n]), n
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_checkpointed_chunk_recompute_uses_the_same_draws():
    """CPU, f64: the fine embedding's inputs in the backward's recompute
    equal the forward's, chunk by chunk, within 1e-9 (CPU kernels do not
    promise the same bits twice; samples drawn anew would move them by
    ~0.1). tests/test_torch_gpu.py holds the same bit for bit on the card
    with K1'."""
    from test_torch_gpu import recompute_inputs
    fwd, bwd, n_fwd, n_bwd = recompute_inputs(torch.device("cpu"),
                                              torch.float64)
    for a, b in zip(fwd, bwd):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-9)
    assert (n_fwd, n_bwd) == (0, 0)


def test_psnr_and_mse_match_jax():
    rng = np.random.default_rng(9)
    a, b = rng.uniform(size=(2, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(float(training.mse(_t(a), _t(b))),
                               float(jtrain.mse(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(training.psnr(_t(a), _t(b))),
                               float(jtrain.psnr(a, b)), rtol=1e-6)


# ------------------------------------------------------------- config, data

@pytest.mark.parametrize("overrides", [
    [], ["data_dir=/tmp/run", "nerf_model.n_samples=8",
         "nerf_model.original_image_size=[48,64]", "nerf_training.fusion=without",
         "nerf_model.remat=false", "valid_perspective_src_indices=[1]"]])
def test_config_matches_jax(overrides):
    """The composed nerf_1_view_wo config, with and without overrides."""
    want = jconfig.load_config(str(jconfig.__file__).rsplit("/", 2)[0]
                               + "/configs", "nerf_1_view_wo", overrides)
    got = config.load_config(overrides, "nerf_1_view_wo")
    assert got == want.to_dict()
    assert got.nerf_model.n_views == 1 and got.nerf_training.batch_size == 8


def test_synthetic_dataset_matches_jax(tmp_path):
    """The writer's colour and camera files equal the JAX writer's for one
    seed, bit for bit."""
    kw = dict(n_samples=2, n_perspectives=3, height=12, width=16, rng=3)
    jsyn.write_synthetic_dataset(str(tmp_path / "j"), **kw)
    synthetic.write_synthetic_dataset(str(tmp_path / "p"), **kw)
    want = jload.load_dataset_nerf(3, str(tmp_path / "j"))
    got = loaders.load_dataset_nerf(3, str(tmp_path / "p"))
    assert len(got) == len(want) == 2
    for i in range(2):
        np.testing.assert_array_equal(
            got.datasets["color"].read_sample(i),
            want.datasets["color"].read_sample(i))
        for a, b in zip(got.datasets["camera_config"].read_sample(i),
                        want.datasets["camera_config"].read_sample(i)):
            np.testing.assert_array_equal(a["pose"], b["pose"])
            np.testing.assert_array_equal(a["intrinsics"], b["intrinsics"])


def test_data_generator_matches_jax(tmp_path, monkeypatch):
    """MVNeRFDataGenerator batches bit-equal to the JAX generator's for one
    seed over two epochs (shuffles included), on one synthesized dataset.
    The JAX generator runs its numpy fallbacks, which the port copies (its
    optional host C++ normalises rays in float64)."""
    monkeypatch.setattr(native, "load", lambda build=True: None)
    path = str(tmp_path / "ds")
    loaders.ensure_dataset(path, 5, n_samples=3, image_size=(12, 16))
    loaders.ensure_dataset(path, 5, n_samples=9)      # present: a no-op
    kw = dict(n_rays_train=10, batch_size=2, n_views=1, shuffle=True, rng=11)
    want = jgen.MVNeRFDataGenerator(jload.load_dataset_nerf(5, path), **kw)
    got = generators.MVNeRFDataGenerator(loaders.load_dataset_nerf(5, path),
                                         **kw)
    assert len(got) == len(want) == 1
    for _ in range(2):
        for i in range(len(got)):
            g, w = got[i], want[i]
            for a, b in zip(g[0] + (g[1],), w[0] + (w[1],)):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
        got.on_epoch_end()
        want.on_epoch_end()
    inputs, labels = generators.to_device(*got[0], torch.device("cpu"))
    assert tuple(inputs[2].shape) == (2, 1, 12, 16, 3)
    assert tuple(labels.shape) == (2, 10, 3)


def test_trainer_runs_end_to_end_on_the_cpu(tmp_path):
    """The entry point at a tiny size: synthesized data, one step, a
    validation render before and after; finite loss and PSNR. The chain
    halves run through K1' (`pallas_mlp`, off by default), as chip_smoke.py
    trains."""
    cfg = config.load_config([
        "device=cpu", f"data_dir={tmp_path}",
        "nerf_model.original_image_size=[24,32]", "nerf_model.n_samples=4",
        "nerf_model.n_rays_train=16", "nerf_model.vit_size=[32,32]",
        "nerf_model.vit_dim=32", "nerf_model.vit_heads=2",
        "nerf_model.vit_hooks=[1,2,3,4]", "nerf_model.n_blocks=2",
        "nerf_model.n_features=8", "nerf_training.n_epochs=1",
        "nerf_training.eval_after_epochs=1", "nerf_training.batch_size=2",
        "dataset.n_perspectives=4", "dataset.n_synthetic_samples=2",
        "valid_sample_idx=0", "valid_perspective_src_indices=[0]",
        "valid_perspective_tgt_idx=2", "nerf_model.pallas_mlp=true"],
        "nerf_1_view_wo")
    state, history = train_nerf._main(cfg)
    assert state.step == 1 and len(history["steps"]) == 1
    assert np.isfinite(history["steps"][0]["loss"])
    assert [e for e, _ in history["valid"]] == [0, 1]
    assert all(np.isfinite(v) for _, v in history["valid"])
    assert state.model.pallas_mlp and state.model.remat
    assert not state.model.corner_gather
