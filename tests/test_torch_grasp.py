"""tcnerf_torch's grasp serving stack against the JAX package on the CPU:
se3, the probe projection, `Affine`, `GraspReadout`, `GraspEBM`,
`PoseOptimizer`, `compute_results`, `GraspPipeline.infer` and
`build_grasp_model`.

Sizes are the JAX suite's (tests/test_grasp.py): the `TINY` goal model
(48x64 sources, n_features 32, 3 5-d poses = 18 probes, 2 blocks, hidden
32, ViT 32^2 dim 32) and the CLIP-tiny language model (fusion v4 with
dense text gate and elu, n_features 256, CLIP layers (1, 1, 1, 1), width
8, 32^2, embed 32, text width 16 / 1 layer). Three source views on a
camera ring around the workspace; images, poses and parameters from numpy
seeds; the parameters fill the flax tree (shapes from `jax.eval_shape`)
and reach the port through `from_flax`. Each test names its bar.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion import _close, _fill, _t
from tcnerf.clip import tokenizer as jtok
from tcnerf.core import projection as jproj
from tcnerf.core import se3 as jse3
from tcnerf.models import checkpoint as jckpt
from tcnerf.models import grasp as jgrasp
from tcnerf.models import pipeline as jpipeline
from tcnerf.nn.grasp_readout import GraspReadout as FlaxReadout
from tcnerf.opt import pose_optimizer as jpo
from tcnerf.train import config as jconfig
from tcnerf.train import grasp_common as jcommon
from tcnerf_torch.core import projection, se3
from tcnerf_torch.data.synthetic import camera_ring
from tcnerf_torch.models import grasp, pipeline
from tcnerf_torch.nn.grasp_readout import GraspReadout
from tcnerf_torch.opt import pose_optimizer as po
from tcnerf_torch.params import from_flax, init_params
from tcnerf_torch.tasks.transform import Affine
from tcnerf_torch.train import config, grasp_common

H, W = 48, 64
TINY = dict(n_views=1, n_features=32, original_image_size=(H, W),
            n_5d_poses=3, n_blocks=2, hidden_size=32, vit_size=(32, 32),
            vit_patch=16, vit_dim=32, vit_heads=2, vit_hooks=(1, 2, 3, 4))
GOAL = dict(TINY, readout_activation="elu", readout_kernel_init="glorot_uniform",
            readout_use_bias=True)
LANGUAGE = dict(TINY, n_features=256, fusion="v4", fusion_use_dense=True,
                fusion_activation="elu", clip_layers=(1, 1, 1, 1),
                clip_width=8, clip_embed_dim=32, clip_text_width=16,
                clip_text_layers=1, clip_image_size=32,
                readout_activation="elu", readout_kernel_init="he_normal",
                readout_use_bias=True)
WORKSPACE = ((0.35, 0.85), (-0.25, 0.25), (0.0, 0.2))
N_IMAGES = 3
PROMPT = "grasp the red ball"


def _highest(fn):
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with jax.default_matmul_precision("highest"):
            return fn(*a, **kw)
    return wrapped


def _scene(seed=0):
    """Three views on a ring around the workspace: images [1, 3, H, W, 3],
    intrinsics and inverse extrinsics [1, 3, 4, 4]."""
    rng = np.random.default_rng(seed)
    cfgs = camera_ring(N_IMAGES, height=H, width=W)
    k4 = np.tile(np.eye(4, dtype=np.float32), (N_IMAGES, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in cfgs]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in cfgs], np.float32)
    images = rng.uniform(size=(1, N_IMAGES, H, W, 3)).astype(np.float32)
    return images, k4[None], ext[None]


def _poses(rng, n, rep="quaternion"):
    t = rng.uniform([lo for lo, _ in WORKSPACE], [hi for _, hi in WORKSPACE],
                    (1, n, 3)).astype(np.float32)
    r = rng.normal(size=(1, n, 4 if rep == "quaternion" else 6))
    return t, r.astype(np.float32)


def _fold(x):
    return x.reshape((N_IMAGES, 1) + x.shape[2:])


@pytest.fixture(scope="module", params=["goal", "language"])
def models(request):
    """(kind, kw, flax model, flax params, port models by corner_gather,
    the scene and its JAX feature image [1, 3, H, W, C])."""
    kw = GOAL if request.param == "goal" else LANGUAGE
    fm = jgrasp.GraspEBM(**kw)
    images, intr, ext = _scene()
    poses = jnp.tile(jnp.eye(4), (N_IMAGES, 2, 1, 1))
    args = [poses, jnp.asarray(_fold(images)), jnp.asarray(_fold(intr)),
            jnp.asarray(_fold(ext))]
    if kw.get("fusion"):
        args.append(jnp.zeros((1, 77), jnp.int32))
    shapes = jax.eval_shape(functools.partial(fm.init, method="init_all"),
                            jax.random.PRNGKey(0), *args)["params"]
    params = _fill(shapes, np.random.default_rng(3))
    state = from_flax(params)
    ports = {}
    for corner in (True, False):
        m = grasp.GraspEBM(**kw, corner_gather=corner)
        m.load_state_dict(state, strict=True)
        ports[corner] = m.eval()
    tokens = jtok.tokenize(PROMPT) if kw.get("fusion") else None
    feats = _highest(jax.jit(functools.partial(
        fm.apply, method="compute_features")))(
            {"params": params}, jnp.asarray(images),
            None if tokens is None else jnp.asarray(tokens))
    return dict(kind=request.param, kw=kw, fm=fm, params=params,
                ports=ports, scene=(images, intr, ext), tokens=tokens,
                feats=np.asarray(feats))


# ----------------------------------------------------------------- se3

SE3_CASES = ["quat_to_matrix", "sixd_to_matrix", "make_homogeneous",
             "pose_to_matrix_quaternion", "pose_to_matrix_6d",
             "matrix_to_quat", "transform_points"]


def _se3_args(name, rng):
    q = rng.normal(size=(5, 4)).astype(np.float32)
    six = rng.normal(size=(5, 6)).astype(np.float32)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    if name == "quat_to_matrix":
        return (q,)
    if name == "sixd_to_matrix":
        return (six,)
    if name == "make_homogeneous":
        return t, np.asarray(jse3.quat_to_matrix(q))
    if name.startswith("pose_to_matrix"):
        rep = name.rsplit("_", 1)[1]
        return t, (q if rep == "quaternion" else six), rep
    # every Shepperd branch: random rotations and the four 180-degree ones
    mats = np.concatenate([np.asarray(jse3.quat_to_matrix(q)),
                           np.diag([1.0, -1, -1])[None],
                           np.diag([-1.0, 1, -1])[None],
                           np.diag([-1.0, -1, 1])[None],
                           np.eye(3)[None]]).astype(np.float32)
    if name == "matrix_to_quat":
        return (mats,)
    homog = np.array(jse3.make_homogeneous(
        np.zeros((9, 3), np.float32), mats))
    homog[:, :3, 3] = rng.normal(size=(9, 3))
    return homog, rng.normal(size=(9, 3)).astype(np.float32)


@pytest.mark.parametrize("name", SE3_CASES)
def test_se3_matches_jax(name):
    """Each se3 function on seeded inputs: 1e-5 absolute in f32."""
    args = _se3_args(name, np.random.default_rng(1))
    fn = name if not name.startswith("pose_to_matrix") else "pose_to_matrix"
    want = _highest(getattr(jse3, fn))(*args)
    got = getattr(se3, fn)(*[_t(a) if isinstance(a, np.ndarray) else a
                             for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("rep", ["quaternion", "6d"])
def test_pose_to_matrix_gradients_match_jax(rep):
    """The gradient of sum(pose_to_matrix(t, r) * G) for a random G with
    respect to t and r: 1e-5 absolute."""
    rng = np.random.default_rng(2)
    t, r = _poses(rng, 6, rep)
    g = rng.normal(size=(1, 6, 4, 4)).astype(np.float32)
    want = _highest(jax.grad(lambda t, r: jnp.sum(
        jse3.pose_to_matrix(t, r, rep) * g), argnums=(0, 1)))(t, r)
    tt, rr = _t(t).requires_grad_(), _t(r).requires_grad_()
    got = torch.autograd.grad((se3.pose_to_matrix(tt, rr, rep) * _t(g)).sum(),
                              [tt, rr])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_probe_projection_matches_jax():
    """project_probe_points and rotate_directions on the scene's cameras:
    1e-3 relative (the fp32 pixel bar of the port's projection)."""
    rng = np.random.default_rng(3)
    images, intr, ext = _scene()
    pts = rng.uniform(0.0, 0.5, (1, 4, 18, 3)).astype(np.float32)
    rots = np.asarray(jse3.quat_to_matrix(
        rng.normal(size=(1, 4, 18, 4)).astype(np.float32)))
    z = np.asarray([0.0, 0.0, 1.0], np.float32)
    want = _highest(jproj.project_probe_points)(pts, intr, ext)
    got = projection.project_probe_points(_t(pts), _t(intr), _t(ext))
    for a, b in zip(got, want):
        _close(a, b)
    _close(projection.rotate_directions(_t(rots), _t(z), _t(ext)),
           _highest(jproj.rotate_directions)(rots, z, ext))


# -------------------------------------------------------------- Affine

@pytest.mark.parametrize("rep", ["quaternion", "6d"])
def test_initial_guesses_are_the_jax_bits(rep):
    """generate_initial_guesses(rng=0), 512 guesses: the JAX optimizer's
    loop of Affine.random and the port's draws for all guesses at once
    give the same float32 bits; the probe grid likewise."""
    kw = dict(workspace_bounds=WORKSPACE, n_initial_guesses=512,
              rotation_representation=rep)
    want = jpo.PoseOptimizer(apply_fn=None, params=None, **kw
                             ).generate_initial_guesses(0)
    got = po.PoseOptimizer(model=torch.nn.Linear(1, 1), **kw
                           ).generate_initial_guesses(0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(grasp.probe_transforms(7),
                                  jgrasp.probe_transforms(7))


def test_affine_matches_jax():
    """Affine's constructors, composition, accessors and inverse against
    the JAX package's copy: 1e-12 absolute (float64)."""
    from tcnerf.tasks.transform import Affine as JAffine
    rng = np.random.default_rng(4)
    for _ in range(3):
        t, q = rng.normal(size=3), rng.normal(size=4)
        a, ja = Affine(t, q / np.linalg.norm(q)), JAffine(t, q / np.linalg.norm(q))
        b = Affine.polar(0.3, 0.7, 0.9, (0.5, 0.0, 0.0))
        jb = JAffine.polar(0.3, 0.7, 0.9, (0.5, 0.0, 0.0))
        for got, want in (((a * b).matrix, (ja * jb).matrix),
                          ((a / b).matrix, (ja / jb).matrix),
                          (a.invert().matrix, ja.invert().matrix),
                          (a.quat, ja.quat), (a.rpy, ja.rpy),
                          (a.to_twist(), ja.to_twist())):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# ---------------------------------------------------------- the readout

@pytest.mark.parametrize("activation,init,bias,n_acts", [
    ("relu", "glorot_uniform", True, 4), ("elu", "glorot_uniform", True, 2),
    ("elu", "he_normal", False, 4)])
def test_grasp_readout_matches_flax(activation, init, bias, n_acts):
    """GraspReadout on random activations [B, N, P, 32] (4, and 2 as the
    2-block model reads), without and with the extra (hash-grid) stream:
    1e-3 relative."""
    rng = np.random.default_rng(5)
    acts = [rng.normal(size=(2, 5, 18, 32)).astype(np.float32)
            for _ in range(n_acts)]
    fm = FlaxReadout(use_bias=bias, activation=activation,
                     kernel_initializer=init)
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0),
                            [jnp.asarray(a) for a in acts])["params"]
    params = _fill(shapes, np.random.default_rng(6))
    want = _highest(fm.apply)({"params": params},
                              [jnp.asarray(a) for a in acts])
    m = GraspReadout(32, n_acts, 18, use_bias=bias, activation=activation,
                     kernel_initializer=init)
    m.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = m([_t(a) for a in acts])
    assert tuple(got.shape) == (2, 5)
    _close(got, want)
    # a readout built without the extra stream refuses one
    with pytest.raises(ValueError):
        m([_t(a) for a in acts], extra=_t(acts[0]))
    # the extra stream (the hash-grid encoding, 16 levels x 2 features):
    # its own downscale, then 5 x 64 inputs to the combined downscale
    extra = rng.normal(size=(2, 5, 18, 32)).astype(np.float32)
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0),
                            [jnp.asarray(a) for a in acts],
                            jnp.asarray(extra))["params"]
    assert "activation_downscale_extra" in shapes
    params = _fill(shapes, np.random.default_rng(7))
    want = _highest(fm.apply)({"params": params},
                              [jnp.asarray(a) for a in acts],
                              jnp.asarray(extra))
    m = GraspReadout(32, n_acts, 18, use_bias=bias, activation=activation,
                     kernel_initializer=init, extra_features=32)
    m.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = m([_t(a) for a in acts], extra=_t(extra))
    _close(got, want)


def test_init_params_follows_the_readout_initializers():
    """Seeded weights of the readout: glorot_uniform inside its limit with
    the uniform's std, he_normal truncated at 2 std with flax's scale."""
    for init in ("glorot_uniform", "he_normal"):
        m = GraspReadout(128, 4, 42, kernel_initializer=init)
        init_params(m, torch.Generator().manual_seed(0))
        w = m.readout_block_0.layer_0.weight.detach().double()
        fan_out, fan_in = w.shape
        if init == "glorot_uniform":
            limit = np.sqrt(6 / (fan_in + fan_out))
            assert float(w.abs().max()) <= limit
            np.testing.assert_allclose(float(w.std()), limit / np.sqrt(3),
                                       rtol=0.02)
        else:
            std = np.sqrt(2 / fan_in)
            assert float(w.abs().max()) <= 2 * std / .87962566103423978
            np.testing.assert_allclose(float(w.std()), std, rtol=0.02)
        lecun = m.combined_activation_downscale.weight.detach().double()
        np.testing.assert_allclose(float(lecun.std()),
                                   1 / np.sqrt(lecun.shape[1]), rtol=0.05)


# ------------------------------------------------------------- GraspEBM

def test_init_params_fills_the_whole_grasp_tree(models):
    """params.init_params on a whole GraspEBM (goal; language with the CLIP
    towers and V4): every leaf finite, the same seed the same tensors, the
    readout's kernels at their flavour's scale."""
    kw = models["kw"]
    ms = [grasp.GraspEBM(**kw) for _ in range(2)]
    for m in ms:
        init_params(m, torch.Generator().manual_seed(4))
    for (n, a), (_, b) in zip(ms[0].state_dict().items(),
                              ms[1].state_dict().items()):
        assert torch.isfinite(a).all() and torch.equal(a, b), n
    w = ms[0].grasp_readout.readout_block_1.layer_0.weight.detach().double()
    std = float(w.std())
    want = (np.sqrt(2 / 64) if kw["readout_kernel_init"] == "he_normal"
            else np.sqrt(6 / 128) / np.sqrt(3))
    np.testing.assert_allclose(std, want, rtol=0.1)


@pytest.mark.parametrize("fusion", ["v0", "v1"])
def test_compute_features_v0_v1_match_flax(fusion):
    """GraspEBM.compute_features with the V0 and V1 decoders (the CLIP
    pyramid and the visual features, no text gate): 1e-3 relative."""
    kw = dict(LANGUAGE, fusion=fusion)
    for k in ("fusion_use_dense", "fusion_activation"):
        kw.pop(k)
    fm = jgrasp.GraspEBM(**kw)
    images, intr, ext = _scene()
    args = [jnp.tile(jnp.eye(4), (N_IMAGES, 2, 1, 1)),
            jnp.asarray(_fold(images)), jnp.asarray(_fold(intr)),
            jnp.asarray(_fold(ext)), jnp.zeros((1, 77), jnp.int32)]
    shapes = jax.eval_shape(functools.partial(fm.init, method="init_all"),
                            jax.random.PRNGKey(0), *args)["params"]
    params = _fill(shapes, np.random.default_rng(9))
    want = _highest(jax.jit(functools.partial(
        fm.apply, method="compute_features")))({"params": params},
                                               jnp.asarray(images))
    m = grasp.GraspEBM(**kw)
    m.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = m.eval().compute_features(_t(images))
    _close(got, want)



def test_compute_features_matches_flax(models):
    """encode (the 2x bilinear upsample) for the goal model, the v4 fusion
    with the prompt's text embedding for the language model: 1e-3
    relative."""
    images = models["scene"][0]
    tokens = models["tokens"]
    with torch.no_grad():
        got = models["ports"][True].compute_features(
            _t(images), None if tokens is None else torch.as_tensor(tokens))
    assert tuple(got.shape) == models["feats"].shape
    _close(got, models["feats"])


@pytest.mark.parametrize("corner", [True, False])
def test_energy_matches_flax(models, corner):
    """GraspEBM.energy of 6 poses in the 3 views (folded to [3, 1]):
    1e-3 relative; `prepare` + `energy_prepared` is the same function."""
    fm = jgrasp.GraspEBM(**models["kw"], corner_gather=corner)
    images, intr, ext = models["scene"]
    t, r = _poses(np.random.default_rng(7), 6)
    poses = np.asarray(jse3.pose_to_matrix(np.tile(t, (3, 1, 1)),
                                           np.tile(r, (3, 1, 1))))
    args = [_fold(images), _fold(intr), _fold(ext), _fold(models["feats"])]
    want = _highest(jax.jit(functools.partial(fm.apply, method="energy")))(
        {"params": models["params"]}, jnp.asarray(poses),
        *map(jnp.asarray, args))
    m = models["ports"][corner]
    with torch.no_grad():
        got = m.energy(_t(poses), *map(_t, args))
        prepared = m.prepare(_t(args[0]), _t(args[3]))
        again = m.energy_prepared(_t(poses), prepared, _t(args[1]),
                                  _t(args[2]))
    assert tuple(got.shape) == (3, 6)
    assert (prepared.corner is not None) == corner
    _close(got, want)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("rep", ["quaternion", "6d"])
def test_energy_pose_gradient_matches_flax(models, rep):
    """d(sum E)/d(t, r) through energy_from_pose_params, on corner_gather:
    1e-3 relative, in f64 on both sides. In f32 the gradient is only
    piecewise smooth (its slope jumps where a relu input changes sign or
    a probe changes bilinear cell), so a rounding can pick the other
    piece: the JAX package's own f32 gradient is ~1e-4 of its largest
    entry from its f64 one, and the two packages' f32 gradients differ by
    up to 0.4% on single entries, while their f64 gradients agree to
    1e-12."""
    images, intr, ext = models["scene"]
    t, r = _poses(np.random.default_rng(8), 5, rep)
    t3, r3 = np.tile(t, (3, 1, 1)), np.tile(r, (3, 1, 1))
    args = [_fold(images), _fold(intr), _fold(ext), _fold(models["feats"])]
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        models["params"])
        f64 = [jnp.asarray(a, jnp.float64) for a in args]

        def e_sum(t, r):
            return jnp.sum(models["fm"].apply(
                {"params": params}, t, r, *f64, rep,
                method="energy_from_pose_params"))

        want = jax.jit(jax.grad(e_sum, argnums=(0, 1)))(
            jnp.asarray(t3, jnp.float64), jnp.asarray(r3, jnp.float64))
        want = [np.asarray(w) for w in want]
    m = copy.deepcopy(models["ports"][True]).double()
    tt, rr = (torch.as_tensor(x, dtype=torch.float64).requires_grad_()
              for x in (t3, r3))
    energy = m.energy_from_pose_params(
        tt, rr, *(torch.as_tensor(a, dtype=torch.float64) for a in args), rep)
    got = torch.autograd.grad(energy.sum(), [tt, rr])
    for a, b in zip(got, want):
        _close(a.numpy(), b)


# ------------------------------------------------------- pose optimizer
#
# The ascent is compared in f64 on both sides. Adam's first step is a sign
# step (g / (|g| + 1e-8)), so a gradient entry near zero whose f32 sign
# differs between the packages (see test_energy_pose_gradient_matches_flax)
# moves that pose coordinate by twice the learning rate; in f64 the
# gradients agree to ~1e-12.

def _f64(models):
    """The JAX params and the scene's features in f64 (call under
    jax.enable_x64), and an f64 copy of the port model (corner_gather)."""
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    models["params"])
    images = jnp.asarray(models["scene"][0], jnp.float64)
    tokens = models["tokens"]
    feats = jax.jit(functools.partial(models["fm"].apply,
                                      method="compute_features"))(
        {"params": params}, images,
        None if tokens is None else jnp.asarray(tokens))
    port = copy.deepcopy(models["ports"][True]).double()
    return params, np.asarray(feats), port


def _optimizers(models, rep, n, params, port):
    kw = dict(workspace_bounds=WORKSPACE, n_initial_guesses=n,
              n_images=N_IMAGES, rotation_representation=rep,
              clip_translation=True, init_lr_t=0.05, decay_t=0.9,
              init_lr_r=0.05, decay_r=0.09)
    want = jpo.PoseOptimizer(apply_fn=models["fm"].apply, params=params,
                             **kw)
    return want, po.PoseOptimizer(model=port, **kw)


def _inputs64(models):
    return tuple(np.asarray(x, np.float64) for x in models["scene"])


def test_sync_ascent_matches_jax(models):
    """Three synchronized ascent steps from the same 8 guesses (quaternion
    for the goal model, 6d for the language model): poses 1e-4 absolute,
    each step's energies and the final ones 1e-3 relative; the model's
    parameters keep their autograd flags and get no gradient."""
    rep = "quaternion" if models["kind"] == "goal" else "6d"
    with jax.enable_x64(True):
        params, feats, port = _f64(models)
        jopt, opt = _optimizers(models, rep, 8, params, port)
        inputs = _inputs64(models)
        guesses = [g.astype(np.float64)
                   for g in opt.generate_initial_guesses(1)]
        jstate, jtrace = jopt.optimize_pose(jopt.init_state(guesses), inputs,
                                            jnp.asarray(feats), (True, True),
                                            3)
        jfinal = jopt.compute_current_grasp_success(jstate, inputs,
                                                    jnp.asarray(feats))
        jstate, jtrace, jfinal = jax.device_get((jstate, jtrace, jfinal))
    scene = opt.prepare(inputs, feats)
    state, trace = opt.optimize_pose(opt.init_state(guesses), scene,
                                     (True, True), 3)
    np.testing.assert_allclose(state.translations.numpy(),
                               jstate.translations, rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.rotations.numpy(), jstate.rotations,
                               rtol=0, atol=1e-4)
    assert state.opt_t.count == state.opt_r.count == 3
    _close(trace.numpy(), jtrace)
    _close(opt.compute_current_grasp_success(state, scene).numpy(), jfinal)
    assert all(p.requires_grad for p in port.parameters())
    assert all(p.grad is None for p in port.parameters())


def test_alternating_compute_results_matches_jax(models):
    """compute_results with alternating t / r phases
    (n_optimization_steps=2, sync off; 6d for the goal model, quaternion
    for the language model) from the same guesses, with the trajectory:
    poses 1e-4 absolute after each phase, energies 1e-3 relative."""
    rep = "6d" if models["kind"] == "goal" else "quaternion"
    kw = dict(n_optimization_steps=2, init_lr_t=0.05, decay_t=0.9,
              init_lr_r=0.05, decay_r=0.09, sync=False,
              return_trajectory=True)
    with jax.enable_x64(True):
        params, feats, port = _f64(models)
        jopt, opt = _optimizers(models, rep, 8, params, port)
        inputs = _inputs64(models)
        guesses = [g.astype(np.float64)
                   for g in opt.generate_initial_guesses(2)]
        want = jpo.compute_results(jopt, inputs, jnp.asarray(feats),
                                   init_poses=guesses, **kw)
    got = po.compute_results(opt, inputs, feats, init_poses=guesses, **kw)
    _close(got[0], want[0])
    assert len(got[5]) == len(want[5]) == 3
    for poses_got, poses_want in zip(got[5], want[5]):
        for a, b in zip(poses_got, poses_want):
            np.testing.assert_allclose(a.matrix, b.matrix, rtol=0, atol=1e-4)


def test_pipeline_infer_matches_jax(models, tmp_path):
    """GraspPipeline.infer with 8 guesses, 3 images and the 3_images
    schedule (16 synchronized steps; the language model with its prompt
    through each package's tokenizer), both in f64 (the JAX pipeline on
    f64 parameters, its seeded f32 guesses cast to f64): every
    energy 1e-3 relative, the top-k order equal wherever neighbouring
    scores differ by more than that, the top poses 1e-4 absolute. The
    pipeline `from_checkpoints` builds from the JAX package's files of the
    same weights (a backbone and a grasp run) into a model whose grasp
    components were seeded otherwise gives the same energies, bit for
    bit."""
    images, intr, ext = models["scene"]
    text = PROMPT if models["kind"] == "language" else None
    rep = "6d" if models["kind"] == "language" else "quaternion"
    kw = dict(workspace_bounds=WORKSPACE, n_initial_guesses=8,
              n_images=N_IMAGES, rotation_representation=rep)
    with jax.enable_x64(True):
        params, _, port = _f64(models)
        jpipe = jpipeline.GraspPipeline(model=models["fm"], params=params,
                                        **kw)
        jopt = jpipe._ensure_optimizer()
        draw = jopt.generate_initial_guesses
        # its scan carries the poses: f64 guesses, as the energies are
        jopt.generate_initial_guesses = lambda *a: [
            g.astype(np.float64) for g in draw(*a)]
        want = jpipe.infer(images, intr, ext, text=text, rng=3)
    pipe = pipeline.GraspPipeline(model=port, params=None, **kw)
    got = pipe.infer(images, intr, ext, text=text, rng=3)
    _close(got.all_energies, want.all_energies)
    scores = np.sort(want.all_energies)[::-1][:pipe.top_k + 1]
    gaps = np.abs(np.diff(scores)) > 1e-3 * np.abs(scores[:-1])
    for i in range(pipe.top_k):
        if (i == 0 or gaps[i - 1]) and gaps[i]:
            np.testing.assert_allclose(got.poses[i].matrix,
                                       want.poses[i].matrix, rtol=0,
                                       atol=1e-4)
    assert len(got.poses) == len(got.scores) == pipe.top_k
    assert got.scores == sorted(got.scores, reverse=True)
    stage1, run = tmp_path / "stage1", tmp_path / "run"
    jckpt.store(str(stage1 / "model_final"), models["params"],
                jckpt.BACKBONE_COMPONENTS)
    jckpt.store(str(run / "model_final"), models["params"],
                jckpt.GRASP_COMPONENTS)
    fresh = copy.deepcopy(port)
    for c in ("fine_embedding", "visual_features", "grasp_readout"):
        init_params(getattr(fresh, c), torch.Generator().manual_seed(9))
    loaded = pipeline.GraspPipeline.from_checkpoints(
        fresh, str(run), backbone_dir=str(stage1), **kw)
    assert loaded.model is fresh
    again = loaded.infer(images, intr, ext, text=text, rng=3)
    np.testing.assert_array_equal(again.all_energies, got.all_energies)


# ------------------------------------------------------- build_grasp_model

class _Recorder(torch.nn.Module):
    seen = []

    def __init__(self, **kw):
        super().__init__()
        self.seen.append(kw)


@pytest.mark.parametrize("name,fusion", [("goal_1_view", None),
                                         ("language_1_view", "v4")])
def test_build_grasp_model_takes_the_reference_knobs(monkeypatch, name,
                                                     fusion):
    """Both packages' build_grasp_model on each composed grasp config pass
    the same knobs to GraspEBM (the goal flavour: elu, glorot, bias; the
    language flavour: elu, he_normal, the config's readout_bias), and
    the port's model builds and takes the JAX tree."""
    root = str(jconfig.__file__).rsplit("/", 2)[0] + "/configs"
    overrides = ["nerf_model.n_features=32"]
    cfg = config.load_config(overrides, name)
    assert cfg == jconfig.load_config(root, name, overrides).to_dict()
    _Recorder.seen = []
    monkeypatch.setattr(grasp_common, "GraspEBM", _Recorder)
    monkeypatch.setattr(jcommon, "GraspEBM", _Recorder)
    grasp_common.build_grasp_model(cfg, fusion=fusion, device="cpu")
    jcommon.build_grasp_model(cfg, fusion=fusion)
    got, want = _Recorder.seen
    for k in ("workspace_bounds", "hash_levels"):
        want.pop(k, None)
    assert got == want
    flavour = ({"readout_kernel_init": "glorot_uniform",
                "readout_use_bias": True} if fusion is None else
               {"readout_kernel_init": "he_normal", "readout_use_bias": True})
    assert {k: got[k] for k in flavour} == flavour
    assert got["readout_activation"] == "elu" and got["corner_gather"]


def test_build_grasp_model_defaults_to_the_card(monkeypatch):
    """Without `device` the grasp model goes to the card: with no CUDA it
    raises instead of carrying on on the CPU. With device="cpu" its
    weights come from cfg.seed, and a pipeline on it pins fp32 (no TF32
    convolutions or matmuls)."""
    tiny = ["nerf_model.n_features=32", "nerf_model.original_image_size=[48,64]",
            "nerf_model.n_blocks=2", "nerf_model.hidden_size=32",
            "nerf_model.vit_size=[32,32]", "nerf_model.vit_dim=32",
            "nerf_model.vit_heads=2", "nerf_model.vit_hooks=[1,2,3,4]",
            "grasp_model.n_5d_poses=3"]
    cfg = config.load_config(tiny, "goal_1_view")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        m.setattr(grasp_common, "GraspEBM", _Recorder)
        with pytest.raises(RuntimeError, match="CUDA"):
            grasp_common.build_grasp_model(cfg)
    a, b, c = (grasp_common.build_grasp_model(
        config.load_config(tiny + extra, "goal_1_view"), device="cpu")
        for extra in ([], ["seed=0"], ["seed=1"]))
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert {p.device.type for p in a.parameters()} == {"cpu"}
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    pipeline.GraspPipeline(model=a, params=None, workspace_bounds=WORKSPACE)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
