"""tcnerf_torch checkpoint interop against the JAX package on the CPU: the
msgpack codec against `flax.serialization`, `params.to_flax` against
`from_flax`, per-component files and TF tensor bundles across the two
packages both ways, `train_nerf`'s resume, the grasp trainers' backbone,
store and resume, `GraspPipeline.from_checkpoints` and the
`torch_weights_path` branch.

Sizes are the JAX suite's tiny models (tests/test_torch_fusion.py,
tests/test_torch_grasp.py): renderers "without", v0 and v4-elu (48x64,
n_features 256, ViT dim 32 / 2 heads / 32^2, CLIP layers (1, 1, 1, 1),
width 8, embed 32), the goal and language GraspEBMs. Their flax trees take
the shapes of `jax.eval_shape` of flax's `init`, filled from a numpy seed
(`_fill`). Files move bit for bit; a model loaded from the other
package's files computes that package's outputs at the ROADMAP bars
(1e-3 relative in f32, 1e-9 in f64).
"""

import functools
import json
import logging
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from test_torch_fusion import TINY as RENDER_TINY
from test_torch_fusion import _apply, _close, _draw, _fill, _t
from test_torch_fusion import _scene as _render_scene
from test_torch_grasp import GOAL, LANGUAGE, N_IMAGES, WORKSPACE, _fold
from test_torch_grasp import _scene as _grasp_scene
from test_torch_grasp_train import _f64_attention
from tcnerf.clip import import_torch as jimport
from tcnerf.models import checkpoint as jckpt
from tcnerf.models import grasp as jgrasp
from tcnerf.models import pipeline as jpipeline
from tcnerf.models import tf_checkpoint as jtfc
from tcnerf.models.renderer import MVNeRFRenderer as FlaxRenderer
from tcnerf.train import session as jsession
from tcnerf_torch.models import checkpoint as ckpt
from tcnerf_torch.models import grasp, msgpack_codec, pipeline
from tcnerf_torch.models import tf_checkpoint as tfc
from tcnerf_torch.models.renderer import MVNeRFRenderer
from tcnerf_torch.params import from_flax, init_params, to_flax
from tcnerf_torch.train import config, grasp_common, train_goal, train_nerf

# (name, renderer or grasp, its keyword arguments)
MODELS = [
    ("without", "renderer", dict(fusion="without")),
    ("v0", "renderer", dict(fusion="v0")),
    ("v4_elu", "renderer", dict(fusion="v4", fusion_use_dense=True,
                                fusion_activation="elu")),
    ("goal", "grasp", GOAL),
    ("language", "grasp", LANGUAGE),
]


def _flax_module(kind, kw):
    return (FlaxRenderer(n_views=1, **{**RENDER_TINY, **kw})
            if kind == "renderer" else jgrasp.GraspEBM(**kw))


def _port_module(kind, kw, seed=None):
    m = (MVNeRFRenderer(n_views=1, **{**RENDER_TINY, **kw})
         if kind == "renderer" else grasp.GraspEBM(**kw))
    if seed is not None:
        init_params(m, torch.Generator().manual_seed(seed))
    return m.eval()


def _init_args(kind, kw):
    """flax `init`'s inputs and method for the model."""
    if kind == "renderer":
        return (tuple(jnp.asarray(x) for x in _render_scene(1)),), None
    images, intr, ext = _grasp_scene()
    args = [jnp.tile(jnp.eye(4), (N_IMAGES, 2, 1, 1)),
            jnp.asarray(_fold(images)), jnp.asarray(_fold(intr)),
            jnp.asarray(_fold(ext))]
    if kw.get("fusion"):
        args.append(jnp.zeros((1, 77), jnp.int32))
    return tuple(args), "init_all"


def _tree(kind, kw, seed):
    """The model's flax params tree: flax init's shapes, seeded values."""
    fm = _flax_module(kind, kw)
    args, method = _init_args(kind, kw)
    init = functools.partial(fm.init, method=method) if method else fm.init
    shapes = jax.eval_shape(init, {"params": jax.random.PRNGKey(0),
                                   "sampling": jax.random.PRNGKey(1)},
                            *args)["params"]
    return _fill(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def trees():
    """Per model two flax trees of different seeds."""
    return {name: (kind, kw, _tree(kind, kw, 3), _tree(kind, kw, 4))
            for name, kind, kw in MODELS}


def _bits(a):
    """A leaf (numpy, jax or torch, any dtype) as (dtype name, shape,
    bytes)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy(
            ).tobytes()
        a = t.numpy()
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _same_tree(got, want, path=""):
    """Two trees with the same keys (any order) and bit-identical leaves."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if not isinstance(want, dict):
        assert _bits(got) == _bits(want), path
        return
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        _same_tree(got[k], want[k], f"{path}/{k}")


def _same_state(module, tree):
    """The module's tensors equal from_flax(tree), bit for bit."""
    want = from_flax(tree, dtype=None)
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# ------------------------------------------------------------------ codec

def _leaves(dtype, rng):
    """A nested dict in one dtype: every length class of the headers (a
    scalar in a fixext 16, ext 8 / 16 / 32 payloads, an empty leaf)."""
    def leaf(shape):
        a = rng.normal(size=shape) * 100
        return a.astype(np.int32) if dtype == "int32" else a
    return {"outer": {"kernel": leaf((3, 4)), "bias": leaf((4,))},
            "scalar": leaf(()), "empty": leaf((0, 2)),
            "deep": {"a": {"b": leaf((17,))}},
            "k" * 40: leaf((300,)), "big": leaf((20000,))}


def _as(tree, fn):
    return {k: _as(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16", "int32"])
def test_codec_matches_flax_both_ways(dtype):
    """Each dtype through nested maps: the port's bytes are flax
    `to_bytes`'s for the same dict; the port reads flax's bytes and flax
    reads the port's, bit for bit (bfloat16 leaves are torch tensors on
    the port's side and ml_dtypes arrays on flax's)."""
    base = _leaves(dtype, np.random.default_rng(0))
    if dtype == "bfloat16":
        jtree = _as(base, lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)))
        ptree = _as(base, lambda a: torch.as_tensor(a).to(torch.bfloat16))
    else:
        jtree = ptree = _as(base, lambda a: np.asarray(a, dtype))
    if dtype == "float32":
        jtree = ptree = {**jtree, "np_scalar": np.float32(2.5)}
    blob = fser.to_bytes(jtree)
    assert msgpack_codec.dumps(ptree) == blob
    got = msgpack_codec.loads(blob)
    _same_tree(got, ptree)
    _same_tree(fser.msgpack_restore(msgpack_codec.dumps(ptree)), jtree)


def test_codec_chunked_leaves_match_flax(monkeypatch, tmp_path):
    """With MAX_CHUNK_SIZE cut to 64 bytes on both sides, flax's chunked
    form of every larger leaf: the same bytes, read back both ways."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b": {"c": np.arange(40, dtype=np.int32),
                  "d": np.ones(3, np.float64)}}
    blob = fser.to_bytes(tree)
    assert msgpack_codec.dumps(tree) == blob
    assert set(msgpack.unpackb(blob, ext_hook=lambda c, d: None)["a"]) == {
        msgpack_codec.CHUNKED, "shape", "chunks"}
    path = str(tmp_path / "x.msgpack")
    assert msgpack_codec.write(path, tree) == len(blob)
    _same_tree(msgpack_codec.read(path), tree)
    _same_tree(fser.msgpack_restore(msgpack_codec.dumps(tree)), tree)
    bad = fser.msgpack_serialize({"leaf": {msgpack_codec.CHUNKED: True,
                                           "shape": {"0": 3}}})
    with pytest.raises(ValueError, match="leaf"):
        msgpack_codec.loads(bad)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 200, 300, 70000])
def test_codec_takes_every_ext_header(n):
    """fixext 1/2/4/8/16 and ext 8/16/32 headers as msgpack packs them:
    the type and the payload; ext 3 (a numpy scalar) reads as its
    array."""
    payload = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    packed = msgpack.packb(msgpack.ExtType(1, payload))
    r = msgpack_codec._Reader(packed)
    code, got = r._ext(r._byte())
    assert code == 1 and bytes(got) == payload and r.pos == len(packed)
    scalar = fser.to_bytes({"s": np.float64(n)})
    assert msgpack_codec.loads(scalar)["s"] == n


def test_codec_rejects_what_flax_does_not_write():
    """Outside the subset: a complex ext, a list, a negative int, a float
    value, bytes after the map, a truncated blob, a non-str key."""
    for blob in (fser.msgpack_serialize({"c": 1j}),
                 msgpack.packb({"l": [1, 2]}), msgpack.packb({"i": -3}),
                 msgpack.packb({"f": 1.5}),
                 fser.to_bytes({"a": np.ones(2)}) + b"\x00",
                 fser.to_bytes({"a": np.ones(2)})[:-3]):
        with pytest.raises(ValueError):
            msgpack_codec.loads(blob)
    for tree in ({1: np.ones(2)}, {"f": 1.5}, [np.ones(2)]):
        with pytest.raises(ValueError):
            msgpack_codec.dumps(tree)


# ------------------------------------------------------- layouts, files

@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_to_flax_inverts_from_flax(trees, name):
    """Every component of the model, both ways, bit for bit:
    to_flax(from_flax(tree)) is the tree, from_flax(to_flax(module)) the
    module's tensors; in f64 as in f32."""
    kind, kw, tree, _ = trees[name]
    m = _port_module(kind, kw)
    m.load_state_dict(from_flax(tree), strict=True)
    for component, sub in tree.items():
        module = getattr(m, component)
        _same_tree(to_flax(module), sub)
        _same_state(module, to_flax(module))
    m64 = _port_module(kind, kw).double()
    m64.load_state_dict(from_flax(tree, np.float64), strict=True)
    for component, sub in tree.items():
        _same_tree(to_flax(getattr(m64, component)),
                   _as(sub, lambda a: np.asarray(a, np.float64)))


def _components(kind, kw):
    if kind == "grasp":
        return jckpt.GRASP_COMPONENTS + (
            ("combine_clip_visual",) if kw.get("fusion") else ())
    return (jckpt.RENDERER_WITHOUT_COMPONENTS if kw["fusion"] == "without"
            else jckpt.RENDERER_COMPONENTS)


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_component_files_cross_both_ways(trees, name, tmp_path):
    """JAX `ckpt.store` -> port `load` into a model seeded otherwise: the
    tensors are the tree's, bit for bit; port `store` of that model -> JAX
    `ckpt.load` into the other tree: the stored leaves come back bit for
    bit. Components the model lacks (`hash_tables`; `combine_clip_visual`
    of "without") get no file, in either package."""
    kind, kw, tree, other = trees[name]
    comps = _components(kind, kw)
    jckpt.store(str(tmp_path / "j" / "model_final"), tree, comps)
    m = _port_module(kind, kw, seed=9)
    assert ckpt.load(str(tmp_path / "j" / "model_final"), m, comps)
    present = [c for c in comps if c in tree]
    for c in present:
        _same_state(getattr(m, c), tree[c])
    ckpt.store(str(tmp_path / "p" / "model_final"), m, comps)
    written = sorted(os.listdir(tmp_path / "p"))
    assert written == sorted(os.listdir(tmp_path / "j")) == sorted(
        f"model_final_{c}.msgpack" for c in present)
    back = jckpt.load(str(tmp_path / "p" / "model_final"), other, comps)
    for c in present:
        _same_tree(back[c], tree[c])


def test_load_is_all_or_nothing_and_checks_shapes(trees, tmp_path):
    """A missing file: False, nothing changed (JAX: None). A file of
    another component's keys or of another shape: ValueError before any
    tensor changes; flax's `from_bytes` (JAX `ckpt.load`) keeps a leaf of
    another shape, an edge of the reference."""
    kind, kw, tree, other = trees["goal"]
    path = str(tmp_path / "model_final")
    jckpt.store(path, tree, ("fine_embedding", "visual_features"))
    m = _port_module(kind, kw, seed=9)
    before = {k: v.clone() for k, v in m.state_dict().items()}

    def unchanged():
        return all(torch.equal(v, before[k])
                   for k, v in m.state_dict().items())

    assert not ckpt.load(path, m, jckpt.GRASP_COMPONENTS, verbose=True)
    assert jckpt.load(path, tree, jckpt.GRASP_COMPONENTS) is None
    assert unchanged()
    wrong = jax.tree_util.tree_map(lambda a: a, tree["grasp_readout"])
    wrong["readout_head"]["output_layer"]["kernel"] = np.zeros(
        (2, 3), np.float32)
    jckpt.store(path, {"grasp_readout": wrong}, ("grasp_readout",))
    with pytest.raises(ValueError, match="shapes"):
        ckpt.load(path, m, jckpt.GRASP_COMPONENTS)
    assert unchanged()
    loose = jckpt.load(path, tree, ("grasp_readout",))
    assert loose["grasp_readout"]["readout_head"]["output_layer"][
        "kernel"].shape == (2, 3)
    jckpt.store(path, {"grasp_readout": tree["fine_embedding"]},
                ("grasp_readout",))
    with pytest.raises(ValueError, match="missing"):
        ckpt.load(path, m, jckpt.GRASP_COMPONENTS)
    assert unchanged()


def test_tf_bundles_match_jax_both_ways(trees, tmp_path):
    """TF tensor bundles of every goal component: the port's `store_tf`
    writes JAX `store_tf`'s bytes (index and data) for the same weights;
    JAX `store_tf` -> port `load` (the `.index` fallback) and port
    `store_tf` -> JAX `ckpt.load`, bit for bit; `write_bundle` of the same
    tensors writes the same files."""
    kind, kw, tree, other = trees["goal"]
    comps = jckpt.GRASP_COMPONENTS
    jckpt.store_tf(str(tmp_path / "j" / "m"), tree, comps)
    m = _port_module(kind, kw, seed=9)
    assert ckpt.load(str(tmp_path / "j" / "m"), m, comps)
    for c in tree:
        _same_state(getattr(m, c), tree[c])
    ckpt.store_tf(str(tmp_path / "p" / "m"), m, comps)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p")) and len(files) == 6
    for f in files:
        assert ((tmp_path / "p" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes()), f
    back = jckpt.load(str(tmp_path / "p" / "m"), other, comps)
    for c in tree:
        _same_tree(back[c], tree[c])
    rng = np.random.default_rng(5)
    tensors = {"b/kernel": rng.normal(size=(3, 2)).astype(np.float32),
               "a": np.arange(4, dtype=np.int64),
               "c": rng.normal(size=(2,))}
    jtfc.write_bundle(str(tmp_path / "wj"), tensors)
    tfc.write_bundle(str(tmp_path / "wp"), tensors)
    for suffix in (".index", ".data-00000-of-00001"):
        assert ((tmp_path / f"wp{suffix}").read_bytes()
                == (tmp_path / f"wj{suffix}").read_bytes())
    got = tfc.read_bundle(str(tmp_path / "wj"))
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert _bits(got[k]) == _bits(v)


@pytest.mark.parametrize("name", ["without", "v4_elu"])
def test_renderer_from_jax_files_renders_as_flax(trees, name, tmp_path):
    """A renderer seeded otherwise, loaded from JAX-written files (the CLIP
    tower, no checkpoint component in either package, from the same
    tree): the whole hierarchical render with explicit draws, 1e-3."""
    kind, kw, tree, _ = trees[name]
    path = str(tmp_path / "model_final")
    jckpt.store(path, tree, _components(kind, kw))
    m = _port_module(kind, kw, seed=9)
    assert ckpt.load(path, m, _components(kind, kw))
    if "clip_visual" in tree:
        m.clip_visual.load_state_dict(from_flax(tree["clip_visual"]))
    fm = _flax_module(kind, kw)
    inputs = _render_scene(1)
    key = jax.random.PRNGKey(7)
    variables = {"params": tree}
    want = _apply(fm, variables, tuple(jnp.asarray(x) for x in inputs),
                  rngs={"sampling": key})
    with jax.default_matmul_precision("highest"):
        u_c, u_f = fm.apply(variables, 1, 16, RENDER_TINY["n_samples"],
                            method=_draw, rngs={"sampling": key})
    with torch.no_grad():
        got = m(tuple(_t(x) for x in inputs), u_coarse=_t(u_c),
                u_fine=_t(u_f))
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)


# ------------------------------------------------------- serving, training

class _Structural:
    """The flax GraspEBM with an `init` that gives flax init's tree
    structure (`jax.eval_shape`, seeded values): JAX `from_checkpoints`
    inits the model only for its structure, and an eager flax init of even
    the tiny model takes ~40 s on the CPU."""

    def __init__(self, fm):
        self._fm = fm

    def __getattr__(self, name):
        return getattr(self._fm, name)

    def init(self, rng, *args, method=None):
        fn = functools.partial(self._fm.init, method=method) if method \
            else self._fm.init
        return {"params": _fill(jax.eval_shape(fn, rng, *args)["params"],
                                np.random.default_rng(11))}


def test_pipeline_from_checkpoints_matches_jax(trees, tmp_path):
    """One directory of JAX-written files: the backbone (tree A) and a grasp
    run (tree B). Both packages' `from_checkpoints` load the backbone, then
    the grasp components over it: B's weights, bit for bit. The energies
    of the same 6 guesses from the images: f32 1e-3, f64 1e-9 (the JAX
    side with an f64 attention softmax). Without the grasp run, the
    backbone alone loads in both."""
    kind, kw, tree_b, tree_a = trees["goal"]
    jckpt.store(str(tmp_path / "stage1" / "model_final"), tree_a,
                jckpt.BACKBONE_COMPONENTS)
    jckpt.store(str(tmp_path / "grasp" / "model_final"), tree_b,
                jckpt.GRASP_COMPONENTS)
    fm = jgrasp.GraspEBM(**kw)
    for run, tree in (("grasp", tree_b), ("none", None)):
        jpipe = jpipeline.GraspPipeline.from_checkpoints(
            _Structural(fm), str(tmp_path / run), WORKSPACE,
            backbone_dir=str(tmp_path / "stage1"), n_images=N_IMAGES)
        m = _port_module(kind, kw, seed=9)
        readout = {k: v.clone() for k, v in
                   m.grasp_readout.state_dict().items()}
        pipe = pipeline.GraspPipeline.from_checkpoints(
            m, str(tmp_path / run), WORKSPACE,
            backbone_dir=str(tmp_path / "stage1"), n_images=N_IMAGES)
        assert pipe.model is m
        for c in jckpt.BACKBONE_COMPONENTS:
            want = (tree or tree_a)[c]
            _same_tree(jpipe.params[c], want)
            _same_state(getattr(m, c), want)
        if tree is None:
            assert all(torch.equal(v, readout[k]) for k, v in
                       m.grasp_readout.state_dict().items())
            continue
        _same_state(m.grasp_readout, tree["grasp_readout"])
        images, intr, ext = _grasp_scene()
        rng = np.random.default_rng(6)
        t = rng.uniform([lo for lo, _ in WORKSPACE],
                        [hi for _, hi in WORKSPACE], (6, 3))
        q = rng.normal(size=(6, 4))
        from tcnerf_torch.core import se3
        poses = np.tile(se3.pose_to_matrix(torch.as_tensor(t)[None],
                                           torch.as_tensor(q)[None]).numpy(),
                        (N_IMAGES, 1, 1, 1))
        args = (poses, _fold(images), _fold(intr), _fold(ext))
        with jax.default_matmul_precision("highest"):
            want = jax.jit(fm.apply)({"params": jpipe.params},
                                     *[jnp.asarray(a, jnp.float32)
                                       for a in args])
        with torch.no_grad():
            got = m(*[_t(a) for a in args])
        _close(got, want)
        with _f64_attention():
            p64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jpipe.params)
            want = jax.jit(fm.apply)({"params": p64}, *[
                jnp.asarray(a, jnp.float64) for a in args])
        with torch.no_grad():
            got = m.double()(*[torch.as_tensor(np.asarray(a, np.float64))
                               for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-9 * float(np.abs(want).max()))


NERF_WIDTHS = ["nerf_model.original_image_size=[48,64]",
               "nerf_model.n_features=32", "nerf_model.n_samples=8",
               "nerf_model.n_rays_train=32", "nerf_model.vit_size=[32,32]",
               "nerf_model.vit_dim=32", "nerf_model.vit_heads=2",
               "nerf_model.vit_hooks=[1,2,3,4]", "nerf_model.n_blocks=2",
               "nerf_model.hidden_size=32"]
NERF_TINY = NERF_WIDTHS + [
    "nerf_training.n_epochs=2", "nerf_training.eval_after_epochs=1",
    "nerf_training.batch_size=1", "nerf_training.warmup_steps=5",
    "dataset.n_perspectives=5", "dataset.n_synthetic_samples=2",
    "valid_sample_idx=0", "valid_perspective_src_indices=[1]",
    "valid_perspective_tgt_idx=4"]


def test_train_nerf_resumes_a_jax_checkpoint(tmp_path, caplog):
    """A directory that JAX `ckpt.store` and a `training_progress.json` of
    epoch 1 made: `_main` logs the load, starts at JAX's start epoch,
    skips the epoch-0 validation, trains the one round left and stores
    `model_final` with its sidecar; the weights right after the load are
    the files', bit for bit."""
    cfg = config.load_config(NERF_TINY + [f"data_dir={tmp_path}"],
                             "nerf_1_view_wo")
    model_path = cfg.nerf_training.model_path
    source = train_nerf.build_model(cfg, torch.device("cpu"))
    init_params(source, torch.Generator().manual_seed(5))
    tree = {c: to_flax(getattr(source, c))
            for c in jckpt.RENDERER_WITHOUT_COMPONENTS}
    jckpt.store(os.path.join(model_path, "model_final"), tree,
                jckpt.RENDERER_WITHOUT_COMPONENTS)
    with open(os.path.join(model_path, "training_progress.json"), "w") as f:
        json.dump({"epoch": 1}, f)
    fresh = train_nerf.build_model(cfg, torch.device("cpu"))
    train_nerf.init_weights(fresh, cfg)
    for c, sub in tree.items():
        _same_state(getattr(fresh, c), sub)
    assert jsession.init_training_session(model_path)[0] == 1
    with caplog.at_level(logging.INFO):
        state, history = train_nerf._main(cfg, "cpu")
    assert "Model loaded from" in caplog.text
    assert "Starting training from epoch 1" in caplog.text
    assert [e for e, _ in history["valid"]] == [2]
    assert len(history["steps"]) == 2           # 2 scenes, batch 1
    assert json.loads(open(os.path.join(
        model_path, "training_progress.json")).read()) == {"epoch": 2}
    assert ckpt.load_meta(os.path.join(model_path, "model_final")) == {
        "fusion": "without", "fusion_use_dense": False,
        "fusion_activation": "relu", "field": "pixel"}
    back = jckpt.load(os.path.join(model_path, "model_final"), tree,
                      jckpt.RENDERER_WITHOUT_COMPONENTS)
    for c in tree:
        _same_tree(back[c], to_flax(getattr(state.model, c)))


GOAL_TINY = ["nerf_model.original_image_size=[48,64]",
             "nerf_model.n_features=32", "nerf_model.vit_size=[32,32]",
             "nerf_model.vit_dim=32", "nerf_model.vit_heads=2",
             "nerf_model.vit_hooks=[1,2,3,4]", "nerf_model.n_blocks=2",
             "nerf_model.hidden_size=32", "grasp_model.n_5d_poses=3",
             "grasp_training.n_epochs=1", "grasp_training.eval_after_epochs=1",
             "grasp_training.batch_size=2", "dataset.n_perspectives=5",
             "dataset.n_synthetic_samples=2",
             "validation.valid_sample_indices=[0]",
             "validation.grasp_opt_config.optimizer_config."
             "n_initial_guesses=8",
             "validation.grasp_opt_config.optimization_config."
             "n_optimization_steps=2",
             "generator_grasp.n_points_train=16",
             "generator_grasp.n_r_fraction=4"]


def test_train_goal_on_the_port_stage1_then_resumes(tmp_path):
    """Stage 1 (`nerf_1_view_wo`, one round) through the port, then
    `train_goal` with its `backbone_path`: the backbone loads, bit for bit,
    and stays frozen; `best_*` and `model_final_*` hold the grasp
    components (no `hash_tables`). A rerun with one round more resumes
    `model_final` through `resume_or_init` and trains only that round."""
    stage1 = config.load_config(
        NERF_TINY + ["nerf_training.n_epochs=1",
                     f"data_dir={tmp_path / 's1'}"], "nerf_1_view_wo")
    backbone, _ = train_nerf._main(stage1, "cpu")
    overrides = GOAL_TINY + [
        f"data_dir={tmp_path / 'g'}",
        f"grasp_training.backbone_path={stage1.nerf_training.model_path}"]
    cfg = config.load_config(overrides, "goal_1_view")
    run = train_goal.run_goal_training(cfg, device="cpu")
    for c in jckpt.BACKBONE_COMPONENTS:
        _same_state(getattr(run.state.model, c),
                    to_flax(getattr(backbone.model, c)))
    model_dir = cfg.grasp_training.model_path
    for name in ("best", "model_final"):
        assert sorted(f for f in os.listdir(model_dir)
                      if f.startswith(name + "_")) == sorted(
            f"{name}_{c}.msgpack" for c in ("fine_embedding",
                                            "visual_features",
                                            "grasp_readout"))
    trained = {k: v.clone() for k, v in run.state.model.state_dict().items()}
    cfg2 = config.load_config(overrides + ["grasp_training.n_epochs=2"],
                              "goal_1_view")
    fresh = grasp_common.build_grasp_model(cfg2, device="cpu")
    grasp_common.resume_or_init(fresh, cfg2)
    assert all(torch.equal(v, trained[k])
               for k, v in fresh.state_dict().items())
    again = train_goal.run_goal_training(cfg2, device="cpu")
    assert [e for e, _, _ in again.history["valid"]] == [None, 2]
    assert len(again.history["steps"]) == 1
    head = "grasp_readout.readout_head.output_layer.weight"
    assert not torch.equal(again.state.model.state_dict()[head],
                           trained[head])


def test_torch_weights_path_matches_jax_load_pretrained_vit(tmp_path):
    """A timm-layout ViT-B state_dict cut to width 48 (12 blocks, 12 heads,
    as JAX `import_vit_b` fixes them), saved with `torch.save`: the port's
    `init_weights` loads it into the renderer's ViT where no checkpoint is,
    bit for bit JAX `load_pretrained_vit`'s tree; a checkpoint takes
    precedence."""
    g = torch.Generator().manual_seed(0)
    d, n_tok = 48, 5

    def r(*shape):
        return torch.randn(shape, generator=g)

    sd = {"cls_token": r(1, 1, d), "pos_embed": r(1, n_tok, d),
          "patch_embed.proj.weight": r(d, 3, 16, 16),
          "patch_embed.proj.bias": r(d)}
    for i in range(12):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": r(d), f"{p}.norm1.bias": r(d),
                   f"{p}.attn.qkv.weight": r(3 * d, d),
                   f"{p}.attn.qkv.bias": r(3 * d),
                   f"{p}.attn.proj.weight": r(d, d),
                   f"{p}.attn.proj.bias": r(d),
                   f"{p}.norm2.weight": r(d), f"{p}.norm2.bias": r(d),
                   f"{p}.mlp.fc1.weight": r(4 * d, d),
                   f"{p}.mlp.fc1.bias": r(4 * d),
                   f"{p}.mlp.fc2.weight": r(d, 4 * d),
                   f"{p}.mlp.fc2.bias": r(d)})
    weights = str(tmp_path / "vit.pt")
    torch.save(sd, weights)
    cfg = config.load_config(
        NERF_TINY + [f"data_dir={tmp_path}", "nerf_model.vit_dim=48",
                     "nerf_model.vit_heads=12",
                     "nerf_model.vit_hooks=[3,6,9,12]",
                     f"torch_weights_path={weights}"], "nerf_1_view_wo")
    m = train_nerf.build_model(cfg, torch.device("cpu"))
    train_nerf.init_weights(m, cfg)
    vit = m.visual_features.vision_transformer.vit
    want = jimport.load_pretrained_vit(weights, {"visual_features": {
        "vision_transformer": {"vit": {}}}})
    _same_state(vit, want["visual_features"]["vision_transformer"]["vit"])
    other = train_nerf.build_model(cfg, torch.device("cpu"))
    ckpt.store(os.path.join(cfg.nerf_training.model_path, "model_final"),
               other, ckpt.RENDERER_WITHOUT_COMPONENTS)
    train_nerf.init_weights(m, cfg)
    assert torch.equal(vit.cls_token, other.visual_features
                       .vision_transformer.vit.cls_token)
