"""tcnerf_torch's hash-grid field against the JAX package on the CPU: the
encoding (`ops/hashgrid.py`: level scales and the hash bit for bit, the
encoding and its first and second derivatives), `HashGridField`, the
renderer's `field="hashgrid"` and its training step, the NeRF generator's
held-out perspectives, the grasp model's hash stream
(`GraspEBM(hash_encoding=True)`) and its delta-NGF step with trainable
tables, the `hash_tables` checkpoint file, `render_view`'s routing and the
two hash-grid entry points end to end.

Sizes are small: the renderer's fields keep the configs' 16 levels but
2^10-row tables, 16-wide 2-layer MLPs, 8 + 8 samples; the grasp model is
tests/test_torch_grasp.py's tiny goal model with 4 levels of 2^8 rows.
The flax trees take `jax.eval_shape`'s shapes, filled from a numpy seed,
and flax runs under jit. Bars: f32 1e-3 relative (the encoding 1e-6),
bf16 2e-2, f64 1e-9 to 1e-10.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion import _apply, _close, _draw, _fill, _t
from test_torch_grasp import GOAL, WORKSPACE
from test_torch_grasp_train import (LR, N, _batch_scene, _close64,
                                    _f64_attention, _hold_grads, _jax_state,
                                    _one_hot, _pose_params)
from tcnerf.data import generators as jgen
from tcnerf.data import loaders as jload
from tcnerf.models import checkpoint as jckpt
from tcnerf.models import grasp as jgrasp
from tcnerf.models import grasp_training as JGT
from tcnerf.models import training as jtrain
from tcnerf.models.renderer import MVNeRFRenderer as FlaxRenderer
from tcnerf.nn.hashgrid_field import HashGridField as FlaxField
from tcnerf.ops import hashgrid as jhash
from tcnerf.utils import native
from tcnerf_torch.core.rays import get_specific_rays
from tcnerf_torch.data import generators, loaders
from tcnerf_torch.data.synthetic import camera_ring
from tcnerf_torch.models import checkpoint as ckpt
from tcnerf_torch.models import grasp, grasp_training as GT, inference
from tcnerf_torch.models import msgpack_codec, training
from tcnerf_torch.models.pipeline import GraspPipeline
from tcnerf_torch.models.renderer import MVNeRFRenderer
from tcnerf_torch.nn.hashgrid_field import HashGridField
from tcnerf_torch.ops import hashgrid
from tcnerf_torch.params import from_flax, init_params
from tcnerf_torch.train import (config, grasp_common, train_delta_ngf,
                                train_nerf)

BOUNDS = ((-0.7, 1.7), (-1.2, 1.2), (-0.1, 0.7))   # nerf_model/hashgrid
H, W, S, R = 24, 32, 8, 16
RENDER = dict(n_views=1, n_samples=S, near=0.55, far=1.8,
              original_image_size=(H, W), field="hashgrid",
              hashgrid_levels=16, hashgrid_table_log2=10,
              hashgrid_hidden=16, hashgrid_layers=2, hashgrid_bounds=BOUNDS)
HASH_GOAL = dict(GOAL, readout_kernel_init="he_normal", hash_encoding=True,
                 hash_levels=4, hash_size_log2=8, hash_finest_res=64,
                 workspace_bounds=WORKSPACE)


# ---------------------------------------------------------- the encoding

@pytest.mark.parametrize("kw", [
    dict(), dict(finest_resolution=256), dict(n_levels=4),
    dict(n_levels=2), dict(n_levels=3, base_resolution=4,
                           finest_resolution=32), dict(n_levels=1)],
    ids=["16-512", "16-256", "4-levels", "2-levels", "4-32", "1-level"])
def test_level_scales_are_jax_bits(kw):
    """The level scales are JAX's f32 bits (a scale 1 ulp off moves a
    cell edge), and its f64 values under x64."""
    want = np.asarray(jhash.HashGridConfig(**kw).level_scales())
    got = hashgrid.HashGridConfig(**kw).level_scales().numpy()
    assert want.dtype == got.dtype == np.float32
    assert (got.view(np.int32) == want.view(np.int32)).all()
    with jax.enable_x64(True):
        want64 = np.asarray(jhash.HashGridConfig(**kw).level_scales())
    np.testing.assert_array_equal(
        hashgrid.HashGridConfig(**kw).level_scales(torch.float64).numpy(),
        want64)


def test_hash_is_jax_bit_for_bit():
    """The uint32 spatial hash on 100,000 corners up to the finest
    resolution + 1, into 2^14 and 2^10 rows."""
    c = np.random.default_rng(0).integers(0, 514, (100_000, 3))
    for log2 in (14, 10):
        want = np.asarray(jhash._hash(jnp.asarray(c, jnp.int32), 2 ** log2))
        got = hashgrid._hash(torch.as_tensor(c), 2 ** log2).numpy()
        np.testing.assert_array_equal(got, want)


def _points(rng, n):
    """Points inside the box and beyond each face of it."""
    lo, hi = np.asarray(BOUNDS).T
    return rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), (n, 3))


@pytest.mark.parametrize("group", [None, 1, 8000],
                         ids=["all-levels", "one-level", "two-levels"])
def test_hash_encode_matches_jax(monkeypatch, group):
    """hash_encode of 4,000 points (about half outside the box, clipped to
    it) through the full 16 x 2^14 x 2 tables: 1e-6 relative, whether
    the levels run all at once (a small chunk), one at a time (2^20
    points and more) or two at a time."""
    if group is not None:
        monkeypatch.setattr(hashgrid, "_GROUP", group)
    rng = np.random.default_rng(1)
    jcfg = jhash.HashGridConfig(bounds=BOUNDS)
    cfg = hashgrid.HashGridConfig(bounds=BOUNDS)
    tables = rng.uniform(-1, 1, (16, 2 ** 14, 2)).astype(np.float32)
    x = _points(rng, 4000).astype(np.float32).reshape(40, 100, 3)
    want = jax.jit(lambda t, p: jhash.hash_encode(t, p, jcfg))(tables, x)
    got = hashgrid.hash_encode(_t(tables), _t(x), cfg)
    assert tuple(got.shape) == (40, 100, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_hash_encode_derivatives_match_jax_f64():
    """First derivatives in the points and the tables, and the second
    derivative the delta-NGF step takes (of |d sum(w E) / dx|^2, in the
    tables and the points), f64: 1e-10 relative."""
    rng = np.random.default_rng(2)
    kw = dict(n_levels=4, table_size_log2=8, finest_resolution=64,
              bounds=BOUNDS)
    jcfg, cfg = jhash.HashGridConfig(**kw), hashgrid.HashGridConfig(**kw)
    tables = rng.uniform(-1, 1, (4, 256, 2))
    x = _points(rng, 300)
    w = rng.normal(size=(300, 8))

    def jloss(t, p):
        return jnp.sum(jhash.hash_encode(t, p, jcfg) * w)

    def jsecond(t, p):
        gx = jax.grad(jloss, argnums=1)(t, p)
        return jnp.sum(gx ** 2)

    with jax.enable_x64(True):
        first = jax.jit(jax.grad(jloss, argnums=(0, 1)))(tables, x)
        second = jax.jit(jax.grad(jsecond, argnums=(0, 1)))(tables, x)
        want = [np.asarray(a) for a in first + second]
    t = torch.as_tensor(tables).requires_grad_()
    p = torch.as_tensor(x).requires_grad_()
    loss = torch.sum(hashgrid.hash_encode(t, p, cfg) * torch.as_tensor(w))
    gt, gx = torch.autograd.grad(loss, (t, p), create_graph=True)
    got = [gt, gx] + list(torch.autograd.grad(torch.sum(gx ** 2), (t, p)))
    for g, wnt in zip(got, want):
        assert float(np.abs(wnt).max()) > 0
        _close64(g.detach().numpy(), wnt, 1e-10, "derivative")


def _field_tree(fm, x, d, seed):
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0), x, d)["params"]
    tree = _fill(shapes, np.random.default_rng(seed))
    tree["hash_tables"] *= 10          # features of the MLP's scale
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hashgrid_field_matches_flax(dtype):
    """HashGridField (16 levels of 2^10 rows, 3 layers of 64) on points in
    and around the box: f32 1e-3; bf16 2e-2 (rtol and 2e-2 x max |want|
    atol); the tables stay f32."""
    rng = np.random.default_rng(3)
    x = _points(rng, 512).astype(np.float32).reshape(4, 128, 3)
    d = rng.normal(size=(4, 128, 3)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    fm = FlaxField(table_size_log2=10, bounds=BOUNDS, dtype=jdt)
    tree = _field_tree(fm, x, d, 4)
    want = _apply(fm, {"params": tree}, jnp.asarray(x), jnp.asarray(d))
    m = HashGridField(table_size_log2=10, bounds=BOUNDS,
                      dtype=None if jdt is None else torch.bfloat16)
    m.load_state_dict(from_flax(tree), strict=True)
    assert m.hash_tables.dtype == torch.float32
    with torch.no_grad():
        got = m(_t(x), _t(d), features=None, features_projected=True)
    assert got.dtype == (torch.float32 if jdt is None else torch.bfloat16)
    want = np.asarray(want, np.float32)
    if jdt is None:
        _close(got.numpy(), want)
    else:      # the JAX suite's bf16 bar (tests/test_kernels.py:530-533)
        tol = 2e-2
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * float(np.abs(want).max()))


# ---------------------------------------------------------- the renderer

def _render_scene(seed=0):
    rng = np.random.default_rng(seed)
    cfgs = camera_ring(2, height=H, width=W, azimuth_span=0.6)
    k4 = np.eye(4, dtype=np.float32)
    k4[:3, :3] = cfgs[0]["intrinsics"].reshape(3, 3)
    ext = np.linalg.inv(cfgs[0]["pose"]).astype(np.float32)
    src = rng.uniform(size=(1, 1, H, W, 3)).astype(np.float32)
    ro, rd = get_specific_rays(rng.uniform(0, W - 1, R),
                               rng.uniform(0, H - 1, R), cfgs[1]["pose"],
                               cfgs[1]["intrinsics"].reshape(3, 3))
    return (ro[None].astype(np.float32), rd[None].astype(np.float32), src,
            k4[None, None], ext[None, None])


@functools.lru_cache(maxsize=None)
def _render_tree():
    fm = FlaxRenderer(**RENDER)
    inputs = tuple(jnp.asarray(x) for x in _render_scene())
    shapes = jax.eval_shape(fm.init, {"params": jax.random.PRNGKey(0),
                                      "sampling": jax.random.PRNGKey(1)},
                            inputs)["params"]
    tree = _fill(shapes, np.random.default_rng(5))
    for stage in ("coarse_embedding", "fine_embedding"):
        tree[stage]["hash_tables"] *= 10
    return fm, tree


def _port_renderer(tree, dtype=torch.float32):
    m = MVNeRFRenderer(**RENDER)
    m.load_state_dict(from_flax(tree), strict=True)
    return m.to(dtype).eval()


def test_renderer_matches_flax():
    """The hash-grid renderer holds exactly the flax tree; combine_features
    runs no tower ([1, 1, 1, 0], aux 0); render_rays with the JAX draws
    (world-frame directions, no corner image): 1e-3 relative."""
    fm, tree = _render_tree()
    inputs = _render_scene()
    m = _port_renderer(tree)
    assert set(m.state_dict()) == set(from_flax(tree))
    flat = jnp.asarray(inputs[2][0])
    want_c, want_aux = _apply(fm, {"params": tree}, flat, jit=False,
                              method="combine_features")
    with torch.no_grad():
        got_c, aux = m.combine_features(_t(inputs[2][0]))
    assert tuple(got_c.shape) == tuple(want_c.shape) == (1, 1, 1, 0)
    assert float(aux) == float(want_aux) == 0.0
    key = jax.random.PRNGKey(7)
    args = tuple(jnp.asarray(x) for x in inputs)
    want = _apply(fm, {"params": tree}, args, rngs={"sampling": key})
    with jax.default_matmul_precision("highest"):
        u_c, u_f = fm.apply({"params": tree}, 1, R, S, method=_draw,
                            rngs={"sampling": key})
    with torch.no_grad():
        got = m(tuple(_t(x) for x in inputs), u_coarse=_t(u_c),
                u_fine=_t(u_f))
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)


def test_nerf_loss_and_optimizer_match_jax():
    """One nerf_loss of [1, 256] rays in f64 with the JAX draws: the loss
    and every gradient 1e-9 relative of its tensor's max; the loss
    chunked at 128 rays equals the unchunked one. The optimizer puts the
    tables and the MLPs in the "nerf" group and has no "feature" group,
    as optax's labels do."""
    fm, tree = _render_tree()
    rng = np.random.default_rng(6)
    scene = _render_scene()
    ring = camera_ring(2, height=H, width=W, azimuth_span=0.6)
    ro, rd = get_specific_rays(rng.uniform(0, W - 1, 256),
                               rng.uniform(0, H - 1, 256), ring[1]["pose"],
                               ring[1]["intrinsics"].reshape(3, 3))
    inputs = (ro[None], rd[None]) + scene[2:]
    labels = rng.uniform(size=(1, 256, 3))
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     tree)
        j_in = tuple(jnp.asarray(x, jnp.float64) for x in inputs)

        def loss_fn(p):
            rgb, _, fine_rgb, _, aux = fm.apply({"params": p}, j_in,
                                                rngs={"sampling": key})
            return (jtrain.mse(labels, rgb) + jtrain.mse(labels, fine_rgb)
                    + aux)

        loss64, grads64 = jax.jit(jax.value_and_grad(loss_fn))(p64)
        draws = fm.apply({"params": p64}, 1, 256, S, method=_draw,
                         rngs={"sampling": key})
        draws = [torch.as_tensor(np.array(u)) for u in draws]
    m = _port_renderer(tree, torch.float64)
    t_in = tuple(torch.as_tensor(np.asarray(x, np.float64)) for x in inputs)
    loss = training.nerf_loss(m, t_in, torch.as_tensor(labels), *draws)
    loss.backward()
    _close64(float(loss), float(loss64), 1e-9, "loss")
    want = from_flax(jax.device_get(grads64), np.float64)
    for name, p in m.named_parameters():
        _close64(p.grad.numpy(), want[name].numpy(), 1e-9, name)
    with torch.no_grad():
        chunked = training.nerf_loss(m, t_in, torch.as_tensor(labels),
                                     *draws, ray_chunk=128)
    _close64(float(chunked), float(loss), 1e-12, "chunked")
    opt = training.make_nerf_optimizer(m, nerf_lr=1e-2, feature_lr=1e-2)
    assert [g["group"] for g in opt.adam.param_groups] == ["nerf"]
    assert len(opt.adam.param_groups[0]["params"]) == len(list(
        m.parameters()))


def test_generator_excludes_perspectives_like_jax(tmp_path, monkeypatch):
    """MVNeRFDataGenerator(exclude_perspectives=...) gives the JAX
    generator's batches bit for bit over two epochs, and never draws the
    held-out view (as source or target)."""
    monkeypatch.setattr(native, "load", lambda build=True: None)
    path = str(tmp_path / "ds")
    loaders.ensure_dataset(path, 6, n_samples=2, image_size=(12, 16))
    kw = dict(n_rays_train=10, batch_size=1, n_views=2, shuffle=True, rng=3,
              exclude_perspectives=(4,))
    want = jgen.MVNeRFDataGenerator(jload.load_dataset_nerf(6, path), **kw)
    got = generators.MVNeRFDataGenerator(loaders.load_dataset_nerf(6, path),
                                         **kw)
    np.testing.assert_array_equal(got.perspective_pool, [0, 1, 2, 3, 5])
    held = loaders.load_dataset_nerf(6, path).datasets["color"]
    for _ in range(2):
        for i in range(len(got)):
            g, w = got[i], want[i]
            for a, b in zip(g[0] + (g[1],), w[0] + (w[1],)):
                np.testing.assert_array_equal(a, b)
            images = g[0][2][0]
            for j in range(2):
                assert not any(np.array_equal(
                    images[j], held.read_sample_at_idx(s, 4)[..., :3]
                    / np.float32(255)) for s in range(2))
        got.on_epoch_end()
        want.on_epoch_end()


# ------------------------------------------------------- the grasp stream

@functools.lru_cache(maxsize=None)
def _grasp_tree():
    fm = jgrasp.GraspEBM(**HASH_GOAL)
    args = [jnp.tile(jnp.eye(4), (1, 2, 1, 1)), jnp.zeros((1, 1, 48, 64, 3)),
            jnp.zeros((1, 1, 4, 4)), jnp.zeros((1, 1, 4, 4))]
    shapes = jax.eval_shape(functools.partial(fm.init, method="init_all"),
                            jax.random.PRNGKey(0), *args)["params"]
    tree = _fill(shapes, np.random.default_rng(8))
    tree["hash_tables"] *= 10
    return fm, tree


def test_grasp_model_builds_the_flax_tree():
    """GraspEBM(hash_encoding=True) holds the flax tree: a top-level
    `hash_tables` [4, 2^8, 2] and the readout's extra downscale (8
    inputs: 4 levels x 2 features) beside the 2 fused activations'
    (2 blocks), which makes the combined downscale 3 x 64 wide; seeded
    tables are uniform in +-1e-4."""
    _, tree = _grasp_tree()
    m = grasp.GraspEBM(**HASH_GOAL)
    assert set(m.state_dict()) == set(from_flax(tree))
    m.load_state_dict(from_flax(tree), strict=True)
    assert tuple(m.hash_tables.shape) == (4, 256, 2)
    assert tuple(m.grasp_readout.combined_activation_downscale.weight.shape
                 ) == (64, 3 * 64)
    init_params(m, torch.Generator().manual_seed(0))
    t = m.hash_tables.detach()
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 5e-5


def test_grasp_energy_and_pose_gradient_match_flax_f64():
    """Energies and d(sum E)/d(t, r) of 5 poses with the hash stream, f64
    on both sides (JAX with an f64 attention softmax): 1e-9 relative."""
    fm, tree = _grasp_tree()
    rng = np.random.default_rng(9)
    images, intr, ext = _batch_scene(rng, 1)
    t, r = _pose_params(rng, 1, 5, "quaternion")
    with _f64_attention():
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        tree)
        args = [jnp.asarray(a, jnp.float64) for a in (images, intr, ext)]

        def energies(t, r):
            feats = fm.apply({"params": params}, args[0], method="encode")
            return fm.apply({"params": params}, t, r, *args, feats,
                            "quaternion", method="energy_from_pose_params")

        want_e = jax.jit(energies)(t, r)
        want_g = jax.jit(jax.grad(lambda t, r: jnp.sum(energies(t, r)),
                                  argnums=(0, 1)))(t, r)
    m = grasp.GraspEBM(**HASH_GOAL).double()
    m.load_state_dict(from_flax(tree, np.float64), strict=True)
    tt, rr = (torch.as_tensor(x).requires_grad_() for x in (t, r))
    a = [torch.as_tensor(x) for x in (images, intr, ext)]
    e = m.energy_from_pose_params(tt, rr, *a, m.encode(a[0]))
    got_g = torch.autograd.grad(e.sum(), [tt, rr])
    _close64(e.detach().numpy(), np.asarray(want_e), 1e-9, "energies")
    for g, w in zip(got_g, want_g):
        _close64(g.numpy(), np.asarray(w), 1e-9, "pose gradient")


@functools.lru_cache(maxsize=None)
def _jax_delta_step():
    fm, tree = _grasp_tree()
    inputs, labels = _delta_inputs()
    with _f64_attention():
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree)
        state = _jax_state(fm, params, ("grasp_readout", "hash_tables"))
        state, metrics = JGT.delta_ngf_train_step(
            state, [jnp.asarray(x) for x in inputs],
            [jnp.asarray(x) for x in labels], "cross_entropy", "quaternion",
            False)
        return ({k: float(v) for k, v in metrics.items()},
                jax.device_get(state.opt_state[0]["grads"]))


def _delta_inputs():
    rng = np.random.default_rng(13)
    images, intr, ext = _batch_scene(rng, 1)
    l_t, l_r = _pose_params(rng, 1, N, "quaternion")
    g_t, g_r = _pose_params(rng, 1, 4, "quaternion")
    d_t = rng.normal(size=g_t.shape) * 0.01
    d_r = rng.normal(size=g_r.shape) * 0.1
    return ([l_t, l_r, g_t, g_r, images, intr, ext],
            [_one_hot(1, N), d_t, d_r])


def test_delta_ngf_step_trains_the_tables_like_jax():
    """One delta-NGF step with `hash_tables` trainable beside the readout,
    f64: the four metrics 1e-9 relative, the gradients before clipping
    (the tables' through the second-order cosine losses too) 1e-8; then
    the port's step moves the tables and the readout and nothing else."""
    want_metrics, jgrads = _jax_delta_step()
    _, tree = _grasp_tree()
    m = grasp.GraspEBM(**HASH_GOAL).double()
    m.load_state_dict(from_flax(tree, np.float64), strict=True)
    state = GT.create_grasp_train_state(m, LR, ("grasp_readout",
                                                "hash_tables"))
    assert "hash_tables" in state.names
    inputs, labels = _delta_inputs()
    t = [torch.as_tensor(x) for x in inputs]
    lab = [torch.as_tensor(x) for x in labels]
    metrics, grads = GT.delta_ngf_gradients(state, t, lab)
    for k, v in want_metrics.items():
        _close64(float(metrics[k]), v, 1e-9, k)
    _hold_grads(state, grads, jgrads, rtol=1e-8)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    GT.delta_ngf_train_step(state, t, lab)
    moved = {n.split(".", 1)[0] for n, p in m.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved == {"grasp_readout", "hash_tables"}


# ------------------------------------------------------------- the file

def test_hash_tables_file_crosses_both_ways(tmp_path):
    """The `hash_tables` component is one top-level array in flax's file
    (`c7 ...`, an ext, not a map): JAX `ckpt.store` -> port `load` and port
    `store` -> the same bytes, and JAX `ckpt.load` reads the port's files
    bit for bit. The TF-bundle path raises on it in both packages, after
    the components before it."""
    _, tree = _grasp_tree()
    comps = jckpt.GRASP_COMPONENTS
    jpath, ppath = str(tmp_path / "j" / "m"), str(tmp_path / "p" / "m")
    jckpt.store(jpath, tree, comps)
    blob = open(ckpt.component_path(jpath, "hash_tables"), "rb").read()
    assert blob[0] == 0xC8 and blob[3] == 1       # ext 16: an ndarray
    np.testing.assert_array_equal(msgpack_codec.loads(blob),
                                  tree["hash_tables"])
    m = grasp.GraspEBM(**HASH_GOAL)
    init_params(m, torch.Generator().manual_seed(1))
    assert ckpt.load(jpath, m, comps)
    np.testing.assert_array_equal(m.hash_tables.detach().numpy(),
                                  tree["hash_tables"])
    ckpt.store(ppath, m, comps)
    assert open(ckpt.component_path(ppath, "hash_tables"), "rb").read() \
        == blob
    other = jax.tree_util.tree_map(np.zeros_like, tree)
    back = jckpt.load(ppath, other, comps)
    np.testing.assert_array_equal(back["hash_tables"], tree["hash_tables"])
    # all or nothing, and shape-checked: a table of another size
    fresh = grasp.GraspEBM(**HASH_GOAL)
    init_params(fresh, torch.Generator().manual_seed(2))
    before = fresh.hash_tables.detach().clone()
    wrong = dict(tree, hash_tables=tree["hash_tables"][:, :128])
    jckpt.store(jpath, wrong, ("hash_tables",))
    with pytest.raises(ValueError, match="shapes"):
        ckpt.load(jpath, fresh, comps)
    assert torch.equal(fresh.hash_tables.detach(), before)
    # TF bundles: JAX's keras key walk takes maps only
    with pytest.raises(AttributeError):
        jckpt.store_tf(str(tmp_path / "jt" / "m"), tree, comps)
    os.makedirs(tmp_path / "pt")
    with pytest.raises(ValueError, match="one array"):
        ckpt.store_tf(str(tmp_path / "pt" / "m"), m, comps)
    assert sorted(os.listdir(tmp_path / "pt")) == sorted(
        os.listdir(tmp_path / "jt"))
    with pytest.raises(ValueError, match="one array"):
        ckpt.load_tf(str(tmp_path / "pt" / "m"), m, comps)


# -------------------------------------------------- serving and entries

def test_render_view_routes_a_hashgrid_model_to_the_plain_path():
    """The swg default holds for the pixel field only (a hash-grid model
    has hidden 128 too); use_swg=True raises for it; on the CPU the plain
    path renders a finite view."""
    _, tree = _render_tree()
    m = _port_renderer(tree)
    pixel = MVNeRFRenderer(n_views=1, n_samples=S, n_features=8,
                           original_image_size=(H, W), fusion="without",
                           n_blocks=2, vit_size=(32, 32), vit_dim=32,
                           vit_heads=2, vit_hooks=(1, 2, 3, 4))
    cuda = torch.device("cuda")
    assert m.hidden_size == pixel.hidden_size == 128
    assert inference.swg_default(pixel, 1, cuda)
    assert not inference.swg_default(m, 1, cuda)
    cfgs = camera_ring(2, height=H, width=W)
    src = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    with pytest.raises(ValueError, match="plain path"):
        inference.render_view(m, [src], cfgs[:1], cfgs[1], use_swg=True,
                              device="cpu")
    rgb, depth = inference.render_view(
        m, [src], cfgs[:1], cfgs[1], generator=torch.Generator(),
        device="cpu")
    assert rgb.shape == (H, W, 3) and depth.shape == (H, W, 1)


CPU_NERF = ["device=cpu", "'nerf_model.original_image_size=[24,32]'",
            "nerf_model.n_samples=4", "nerf_model.n_rays_train=256",
            "nerf_model.hashgrid_table_log2=10",
            "nerf_training.n_epochs=2", "nerf_training.eval_after_epochs=1",
            "dataset.n_perspectives=6", "valid_perspective_tgt_idx=4",
            "'valid_perspective_src_indices=[1]'"]


def test_train_nerf_hashgrid_entry_runs_and_resumes(tmp_path, monkeypatch):
    """`train_nerf --config-name=nerf_convergence_hashgrid_cpu` cut to two
    one-step rounds on one 24x32 scene: finite losses, the held-out target
    view never drawn, the tables trained, `model_final` holding the four
    components and the sidecar, and a rerun resuming bit for bit."""
    made = []

    class Recorded(generators.MVNeRFDataGenerator):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(train_nerf, "MVNeRFDataGenerator", Recorded)
    over = [a.strip("'") for a in CPU_NERF] + [f"data_dir={tmp_path}"]
    state, history = train_nerf.main(
        ["--config-name=nerf_convergence_hashgrid_cpu", *over])
    assert len(history["steps"]) == 2
    assert all(np.isfinite(s["loss"]) for s in history["steps"])
    np.testing.assert_array_equal(made[0].perspective_pool,
                                  [0, 1, 2, 3, 5])
    model_path = str(tmp_path / "storage/models/nerf/hashgrid_cpu")
    files = sorted(os.listdir(model_path))
    assert [f for f in files if f.endswith(".msgpack")] == sorted(
        f"model_final_{c}.msgpack" for c in (
            "coarse_embedding", "coarse_readout", "fine_embedding",
            "fine_readout"))
    meta = json.load(open(os.path.join(model_path, "model_final_meta.json")))
    assert meta["field"] == "hashgrid"
    cfg = config.load_config(over, "nerf_convergence_hashgrid_cpu")
    seeded = train_nerf.build_model(cfg, torch.device("cpu"))
    trained = state.model.state_dict()
    assert not torch.equal(trained["fine_embedding.hash_tables"],
                           seeded.fine_embedding.hash_tables)
    train_nerf.init_weights(seeded, cfg)
    for k, v in seeded.state_dict().items():
        assert torch.equal(trained[k], v), k


CPU_GRASP = ["device=cpu", "'nerf_model.original_image_size=[48,64]'",
             "nerf_model.n_features=32", "'nerf_model.vit_size=[32,32]'",
             "nerf_model.vit_dim=32", "nerf_model.vit_heads=2",
             "'nerf_model.vit_hooks=[1,2,3,4]'", "nerf_model.n_blocks=2",
             "nerf_model.hidden_size=32", "grasp_model.n_5d_poses=3",
             "grasp_model.hash_levels=4", "grasp_model.hash_size_log2=8",
             "grasp_training.n_epochs=1", "grasp_training.eval_after_epochs=1",
             "grasp_training.batch_size=2", "dataset.n_synthetic_samples=2",
             "'validation.valid_sample_indices=[0]'",
             "validation.grasp_opt_config.optimizer_config."
             "n_initial_guesses=8",
             "validation.grasp_opt_config.optimization_config."
             "n_optimization_steps=2",
             "generator_grasp.pose_augmentation_factor=4",
             "generator_grasp.n_future_poses=4"]


def test_train_delta_ngf_hashgrid_trains_stores_and_serves_the_tables(
        tmp_path):
    """`train_delta_ngf --config-name=dngf_hashgrid` at a tiny size: the
    tables train (the optimizer steps them), `model_final_hash_tables
    .msgpack` holds them, a rerun with one round more resumes them, and
    `GraspPipeline.from_checkpoints` serves them."""
    over = [a.strip("'") for a in CPU_GRASP] + [f"data_dir={tmp_path}"]
    run = train_delta_ngf.main(["--config-name=dngf_hashgrid", *over])
    assert "hash_tables" in run.state.names
    cfg = config.load_config(over, "dngf_hashgrid")
    seeded = grasp_common.build_grasp_model(cfg, device="cpu")
    trained = run.state.model.hash_tables.detach().clone()
    assert not torch.equal(trained, seeded.hash_tables)
    path = os.path.join(cfg.grasp_training.model_path, "model_final")
    stored = msgpack_codec.read(ckpt.component_path(path, "hash_tables"))
    np.testing.assert_array_equal(stored, trained.numpy())
    resumed = grasp_common.resume_or_init(copy.deepcopy(seeded), cfg)
    assert torch.equal(resumed.hash_tables.detach(), trained)
    again = train_delta_ngf.main(["--config-name=dngf_hashgrid", *over,
                                  "grasp_training.n_epochs=2"])
    assert len(again.history["steps"]) == 1
    latest = again.state.model.hash_tables.detach()
    assert not torch.equal(latest, trained)
    pipe = GraspPipeline.from_checkpoints(
        copy.deepcopy(seeded), cfg.grasp_training.model_path,
        cfg.generator_grasp.workspace_bounds, n_images=2,
        n_initial_guesses=4, n_optimization_steps=1)
    assert torch.equal(pipe.model.hash_tables.detach(), latest)
