"""tcnerf_torch.parallel against the JAX package's parallel/ on the CPU.

Four gloo ranks on a (data=2, ray=2) mesh run `parallel.dryrun.rank_checks`
once per module (`dryrun.Launch`, a 120 s join timeout, a 60 s rendezvous
timeout), on the dry run's tiny case with its parameters replaced by a
seeded flax tree (shapes from `jax.eval_shape`, carried over by
`from_flax`) and its sampling draws by JAX's. The tests read the ranks'
results and hold them against the JAX functions run here on the 8 virtual
CPU devices of tests/conftest.py: the layout (mesh positions, batch and
guess blocks, `host_shard_indices`) bit for bit; two updates of the
sharded train step against two of `nerf_train_step`, and two of the
explicit step on each shard's own draws against two of JAX's
`make_explicit_train_step` on the same (2, 2) mesh, both sides in f64 with
a warm-up of one step, so that the second update runs at the full
learning rate (loss rtol 1e-4, parameters rtol 1e-4 / atol 1e-6, the JAX
suite's bars, and each tensor's update at 1e-2 of its largest entry
+ 1e-7); the sharded ascent against `make_explicit_ascent_step` on
`make_mesh(8, data_axis=2)` in f64 (1e-9) and the sharded render against
`render_image_sharded` on the same mesh (1e-3, the f32 renderer bar of
tests/test_torch_models.py). Each test names its bar.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from test_torch_fusion import _fill
from tcnerf.models import training as jtrain
from tcnerf.models.grasp import GraspEBM as FlaxGrasp
from tcnerf.models.renderer import MVNeRFRenderer as FlaxRenderer
from tcnerf.opt.pose_optimizer import PoseOptimizer as JaxPoseOptimizer
from tcnerf.parallel import distributed as jdist
from tcnerf.parallel import explicit as jexplicit
from tcnerf.parallel import mesh as jmesh
from tcnerf.parallel import serve as jserve
from tcnerf_torch.models.inference import render_all_rays
from tcnerf_torch.models.renderer import MVNeRFRenderer
from tcnerf_torch.params import from_flax
from tcnerf_torch.parallel import distributed, dryrun, mesh
from tcnerf_torch.parallel.serve import render_image_sharded

WORLD, DATA = 4, 2
RAY = WORLD // DATA
S = dryrun.NERF["n_samples"]


def _draw(module, b, r, s):
    """The two `sampling` draws render_rays makes, in its order."""
    k_c = module.make_rng("sampling")
    k_f = module.make_rng("sampling")
    return (jax.random.uniform(k_c, (b, r, s)),
            jax.random.uniform(k_f, (b, r, s)))


def _highest(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return jax.device_get(fn(*args, **kw))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def jax_side():
    """The tiny case with seeded flax parameters, and the JAX package's
    results on it: two `nerf_train_step`s and two steps of
    `make_explicit_train_step` with captured draws (f64), the sharded
    render on 8 devices with its per-chunk draws, the sharded ascent."""
    case = dryrun.tiny_case()
    rng = np.random.default_rng(5)
    fm = FlaxRenderer(**case.nerf_cfg)
    inputs = tuple(jnp.asarray(x) for x in case.inputs)
    nerf_params = _fill(jax.eval_shape(fm.init, {
        "params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        inputs)["params"], rng)
    fg = FlaxGrasp(**case.grasp_cfg)
    images, intr, ext = (jnp.asarray(x) for x in case.grasp_scene)
    grasp_params = _fill(jax.eval_shape(
        functools.partial(fg.init, method="init_all"), jax.random.PRNGKey(0),
        jnp.tile(jnp.eye(4), (1, 2, 1, 1)), images, intr, ext)["params"],
        rng)

    key = jax.random.PRNGKey(3)
    b, r = case.labels.shape[:2]
    with jax.enable_x64(True):
        p64 = _f64(nerf_params)
        train_draws = jax.device_get(fm.apply(
            {"params": p64}, b, r, S, method=_draw, rngs={"sampling": key}))
        # JAX's explicit step folds the shard's (data, ray) position into
        # the key; rank r sits at (r // RAY, r % RAY) on both sides
        explicit_draws = [jax.device_get(fm.apply(
            {"params": p64}, b // DATA, r // RAY, S, method=_draw,
            rngs={"sampling": jax.random.fold_in(
                jax.random.fold_in(key, rank // RAY), rank % RAY)}))
            for rank in range(WORLD)]
    # the port's render on 4 ranks pads to fewer chunks than JAX's on 8
    # devices and takes the draws of the first keys of split(rng, n_chunks)
    h, w = case.render_feats.shape[2:4]
    rkey = jax.random.PRNGKey(9)
    variables = {"params": nerf_params}
    n_jax = 8 * -(-h * w // (8 * case.chunk))
    n_port = WORLD * -(-h * w // (WORLD * case.chunk))
    render_draws = [
        _highest(fm.apply, variables, 1, case.chunk, S, method=_draw,
                 rngs={"sampling": k})
        for k in jax.random.split(rkey, n_jax)[:n_port]]
    case = dataclasses.replace(
        case, nerf_state=from_flax(jax.device_get(nerf_params)),
        grasp_state=from_flax(jax.device_get(grasp_params)),
        train_draws=tuple(np.asarray(u) for u in train_draws),
        explicit_draws=[tuple(np.asarray(u) for u in d)
                        for d in explicit_draws],
        render_draws=[tuple(np.asarray(u) for u in d) for d in render_draws])
    # the ranks run while JAX computes here
    launch = dryrun.Launch(WORLD, "cpu", case)

    try:
        mesh8 = jmesh.make_mesh(8, data_axis=2)
        out = dict(case=case, launch=launch,
                   **_jax_train(fm, nerf_params, case, key),
                   render=_highest(
                       jserve.render_image_sharded, mesh8, fm.apply,
                       variables, inputs[2][:1], inputs[3][:1],
                       inputs[4][:1], jnp.asarray(case.render_feats),
                       jnp.asarray(case.tgt_pose), jnp.asarray(case.tgt_k3),
                       rkey, h, w, chunk=case.chunk),
                   **_jax_ascent(fg, grasp_params, case, mesh8))
    except BaseException:
        launch.close()
        raise
    return out


def _jax_train(fm, params, case, key):
    """Two `nerf_train_step`s and two steps of `make_explicit_train_step`
    on the (2, 2) mesh of the first 4 devices, each on the global batch
    with the same key, in f64, with a warm-up of one step (the first update
    at learning rate 0, the second at the full rate): the first loss and
    the params before and after (port names, f64)."""
    def names(tree):
        return from_flax(jax.device_get(tree), dtype=np.float64)

    with jax.enable_x64(True):
        p64 = _f64(params)
        inputs = tuple(jnp.asarray(x, jnp.float64) for x in case.inputs)
        labels = jnp.asarray(case.labels, jnp.float64)
        tx = jtrain.make_nerf_optimizer(warmup_steps=1)
        mesh4 = jmesh.make_mesh(WORLD, data_axis=DATA)
        # replicated on the mesh, so that the explicit step's second call
        # takes the first one's shardings and compilation
        state = jax.device_put(
            jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=p64,
                              tx=tx, opt_state=tx.init(p64),
                              apply_fn=fm.apply),
            NamedSharding(mesh4, PartitionSpec()))
        out = {"params_before": names(p64)}
        steps = {"": jtrain.nerf_train_step,
                 "explicit_": jexplicit.make_explicit_train_step(mesh4)}
        for prefix, step in steps.items():
            s1, m1 = step(state, inputs, labels, key)
            s2, _ = step(s1, inputs, labels, key)
            out.update({prefix + "loss": float(m1["loss"]),
                        prefix + "params": names(s2.params)})
        return out


def _jax_ascent(fg, params, case, mesh8):
    """Energies and make_explicit_ascent_step's gradients on the 8-device
    mesh, in f64."""
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        scene = tuple(jnp.asarray(x, jnp.float64) for x in case.grasp_scene)
        feats = jnp.asarray(case.grasp_features, jnp.float64)
        jopt = JaxPoseOptimizer(apply_fn=fg.apply, params=p64,
                                workspace_bounds=dryrun.WORKSPACE,
                                n_initial_guesses=case.guesses[0].shape[1],
                                n_images=1, n_views=1)
        pstate = jopt.init_state([g.astype(np.float64)
                                  for g in case.guesses])
        energies = jopt.compute_current_grasp_success(pstate, scene, feats)

        def energy_fn(t, r, inputs_, feats_):
            return jopt._energies(p64, t, r, inputs_, feats_)

        sharding = jmesh.pose_shardings(mesh8)
        grads = jexplicit.make_explicit_ascent_step(mesh8, energy_fn)(
            jax.device_put(pstate.translations, sharding),
            jax.device_put(pstate.rotations, sharding), scene, feats)
        return dict(energies=np.asarray(energies),
                    grads=jax.device_get(grads))


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Each of the 4 ranks' results of rank_checks (which raises, and
    `wait` with it, on a failed check of its own)."""
    return jax_side["launch"].wait()


@pytest.fixture
def world1():
    """A world-1 mesh in this process, torn down after the test."""
    try:
        yield mesh.make_mesh(1, device="cpu")
    finally:
        mesh.destroy_mesh()


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_position_matches_jax(ranks, rank):
    """make_mesh(4, data_axis=2) puts rank r where JAX puts device r."""
    jm = jmesh.make_mesh(WORLD, data_axis=DATA)
    want = np.argwhere(jm.devices == jax.devices()[rank])[0]
    assert ranks[rank]["coordinate"] == tuple(int(i) for i in want)


def _shard_of(arr, rank):
    dev = jax.devices()[rank]
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


@pytest.mark.parametrize("rank", range(WORLD))
def test_batch_blocks_match_jax_shards(jax_side, ranks, rank):
    """Each rank's shard_nerf_batch block (5 inputs, labels) is the data of
    JAX's shard_nerf_batch shard on device r, bit for bit."""
    case = jax_side["case"]
    jm = jmesh.make_mesh(WORLD, data_axis=DATA)
    inputs, labels = jmesh.shard_nerf_batch(
        tuple(jnp.asarray(x) for x in case.inputs), jnp.asarray(case.labels),
        jm)
    for got, want in zip(ranks[rank]["batch_block"], inputs + (labels,)):
        np.testing.assert_array_equal(got.numpy(), _shard_of(want, rank))


@pytest.mark.parametrize("rank", range(WORLD))
def test_guess_blocks_match_pose_shardings(jax_side, ranks, rank):
    """shard_guesses is JAX's pose_shardings block on device r."""
    jm = jmesh.make_mesh(WORLD, data_axis=DATA)
    for got, g in zip(ranks[rank]["guess_block"], jax_side["case"].guesses):
        want = jax.device_put(jnp.asarray(g), jmesh.pose_shardings(jm))
        np.testing.assert_array_equal(got.numpy(), _shard_of(want, rank))


@pytest.mark.parametrize("n,rng", dryrun.tiny_case().index_cases)
def test_host_shard_indices_match_jax(ranks, monkeypatch, n, rng):
    """host_shard_indices of rank p of 4 is JAX's for process p of 4."""
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    for p in range(WORLD):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        np.testing.assert_array_equal(ranks[p]["indices"][(n, rng)],
                                      jdist.host_shard_indices(n, rng))


def test_global_batch_array_in_rank_order(ranks):
    """global_batch_array of each rank's [2, 3] batch of its rank is the
    [8, 3] batch of ranks 0, 0, 1, 1, ... on every rank."""
    want = np.repeat(np.arange(WORLD, dtype=np.float32), 2)[:, None]
    for r in ranks:
        np.testing.assert_array_equal(r["global_batch"].numpy(),
                                      np.broadcast_to(want, (2 * WORLD, 3)))


def test_unequal_shards_raise(ranks):
    """A guess axis of 5 over 4 ranks raises ValueError on every rank."""
    assert all(r["unequal_raises"] for r in ranks)


# ----------------------------------------------------------- train steps

def _hold_update(got_params, jax_side, prefix):
    """The parameters after two updates against JAX's: rtol 1e-4 / atol
    1e-6 (the JAX suite's bars), and each tensor's update (after - before)
    at 1e-2 of its largest entry + 1e-7. Adam's second update is about
    lr x sign(grad), of the size of the first bars, so the update is held
    too. Its bar leaves ~7x room over the worst tensor seen (1.5e-3: the
    gradients near Adam's eps, where the JAX model's f32 parts move the
    update); the 1e-7 is for the tensors whose gradient is zero in exact
    arithmetic (attention key biases, biases before a batch-statistics
    norm), which move by rounding over Adam's eps, up to 3.5e-8 on the
    JAX side."""
    before = jax_side["params_before"]
    for name, want in jax_side[prefix + "params"].items():
        got = got_params[name].double().numpy()
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        step = want - before[name].numpy()
        np.testing.assert_allclose(got - before[name].numpy(), step, rtol=0,
                                   atol=1e-2 * np.abs(step).max() + 1e-7,
                                   err_msg=name)


def test_sharded_step_matches_jax(jax_side, ranks):
    """Two updates of the 4-rank sharded step vs two of JAX's
    nerf_train_step on the same params and draws (f64, warm-up 1): the
    first loss rtol 1e-4; every parameter after the second update, see
    _hold_update."""
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jax_side["loss"], rtol=1e-4)
        _hold_update(r["params"], jax_side, "")


def test_explicit_step_matches_jax(jax_side, ranks):
    """Two updates of the 4-rank explicit step, each rank on the draws of
    its shard's folded key, vs two of JAX's make_explicit_train_step on
    the (2, 2) mesh (f64, warm-up 1): the first loss rtol 1e-4; every
    parameter after the second update, see _hold_update. Both normalise
    with each shard's batch statistics."""
    for r in ranks:
        np.testing.assert_allclose(r["explicit_draws_loss"],
                                   jax_side["explicit_loss"], rtol=1e-4)
        _hold_update(r["explicit_draws_params"], jax_side, "explicit_")


def test_explicit_step_is_not_the_sharded_step_with_data_2(ranks):
    """On the (2, 2) mesh the explicit step with each rank's block of the
    global draws differs from the sharded step: its batch statistics are
    the shard's B / 2 images, the sharded step's the global batch's (as
    JAX's two steps differ). Loss and gradients apart by more than
    1e-6."""
    for r in ranks:
        assert abs(r["explicit_global_draws_loss"] - r["loss"]) > \
            1e-6 * abs(r["loss"])
        assert r["diffs"]["explicit_vs_sharded"] > 1e-6


def test_params_identical_on_every_rank(ranks):
    """Every rank's parameters after the sharded updates, bit for bit."""
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k


def test_explicit_step_on_own_streams(ranks):
    """The explicit step on each shard's own stream (two updates):
    finite, the same mean loss on every rank, step count 2, Adam's second
    moment filled (the ranks check determinism and replication
    themselves)."""
    losses = {r["explicit_loss"] for r in ranks}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert all(r["explicit_step"] == 2 and r["explicit_nu"] > 0
               for r in ranks)


@pytest.mark.parametrize("key,bar", [
    ("loss", dryrun.TRAIN_TOL), ("grads", dryrun.TRAIN_TOL),
    ("params", dryrun.TRAIN_TOL), ("energies", 1e-9),
    ("ascent_grads", 1e-9), ("poses", 1e-9), ("render", 1e-5)])
def test_ranks_match_one_process(ranks, key, bar):
    """Each rank's distance of the sharded result from the one-process
    result on the same rank (max-rel, see dryrun), within its bar."""
    assert all(r["diffs"][key] <= bar for r in ranks), \
        [r["diffs"][key] for r in ranks]


# ---------------------------------------------------------------- ascent

def test_ascent_matches_jax(jax_side, ranks):
    """4-rank energies and gathered dE/d(t, r) vs JAX's energies and
    make_explicit_ascent_step on make_mesh(8, data_axis=2), f64: 1e-9 of
    the largest entry."""
    want_e = jax_side["energies"].reshape(-1)
    for r in ranks:
        np.testing.assert_allclose(r["energies"].numpy(), want_e, rtol=0,
                                   atol=1e-9 * np.abs(want_e).max())
        for got, want in zip(r["ascent_grads"], jax_side["grads"]):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-9 * np.abs(want).max())


# --------------------------------------------------------------- serving

def test_sharded_render_matches_jax(jax_side, ranks):
    """The 4-rank render with JAX's per-chunk draws vs JAX's
    render_image_sharded on 8 devices: colour and depth 1e-3."""
    want_rgb, want_depth = jax_side["render"]
    for r in ranks:
        np.testing.assert_allclose(r["render_draws_rgb"].numpy(), want_rgb,
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(r["render_draws_depth"].numpy(),
                                   want_depth, rtol=1e-3, atol=1e-3)


def test_render_does_not_depend_on_world_size(jax_side, ranks, world1):
    """One generator seed: the 4-rank image, the world-1 image in this
    process and render_all_rays agree at 1e-5; world 1 equals
    render_all_rays bit for bit."""
    case = jax_side["case"]
    model = MVNeRFRenderer(**case.nerf_cfg)
    model.load_state_dict(case.nerf_state)
    t = torch.as_tensor
    h, w = case.render_feats.shape[2:4]
    args = (model.eval(), t(case.inputs[2][:1]), t(case.inputs[3][:1]),
            t(case.inputs[4][:1]), t(case.render_feats), t(case.tgt_pose),
            t(case.tgt_k3), h, w, case.chunk)
    with torch.no_grad():
        one = render_image_sharded(
            world1, *args,
            generator=torch.Generator().manual_seed(case.seed))
        plain = render_all_rays(
            *args, generator=torch.Generator().manual_seed(case.seed))
    for got, want in zip(one, plain):
        assert torch.equal(got, want)
    for r in ranks:
        for got, want in zip((r["render_rgb"], r["render_depth"]), one):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------- guards

def test_make_mesh_in_a_bare_process(world1):
    """make_mesh(1) forms a world-1 gloo group on an in-process store; the
    indices of its one process are all of them; a larger mesh needs
    ranks."""
    assert tuple(world1.shape) == (1, 1)
    assert world1.mesh_dim_names == ("data", "ray")
    assert tuple(world1.get_coordinate()) == (0, 0)
    assert distributed.rank_and_world() == (0, 1)
    np.testing.assert_array_equal(distributed.host_shard_indices(7),
                                  np.arange(7))
    with pytest.raises(ValueError, match="group has 1 ranks"):
        mesh.make_mesh(2, device="cpu")


def test_initialize_is_a_no_op_for_one_process():
    """initialize() and initialize(num_processes=1) form no group, as
    jax.distributed's wrapper does nothing on one host."""
    distributed.initialize()
    distributed.initialize("localhost:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    assert distributed.rank_and_world() == (0, 1)


def test_destroy_mesh_leaves_no_group():
    """make_mesh(1) then destroy_mesh: no process group is left for the
    next test file; without a group make_mesh(2) raises."""
    mesh.make_mesh(1, device="cpu")
    mesh.destroy_mesh()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="no process group"):
        mesh.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_mesh(1)
