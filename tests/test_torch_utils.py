"""tcnerf_torch's host utilities and small modules against the JAX package
on the CPU: `ResNetMLPEmbedding`, `sigma_to_alpha`, `GeneratorFeeder`,
the `TCNERF_DATASET_CACHE_MB` budget, `utils.profiling`,
`utils.logging`, and the two demos (`clip/demo.py`,
`models/pipeline.py` `_demo`).

Sizes are tiny (a 2-block MLP of 32, CLIP towers with layers (1, 1, 1, 1),
width 8, 32^2 images, a 2-layer 32-wide text tower). Bars: f32 1e-6
relative for the MLP and the alpha, 1e-5 for the demo's logits.
"""

import copy
import dataclasses
import functools
import io
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion import _apply, _close, _init
from tcnerf.clip import model as jclip
from tcnerf.clip.preprocess import preprocess as jpreprocess
from tcnerf.core import render as jrender
from tcnerf.data import dataset as jdataset
from tcnerf.data import generators as jgen
from tcnerf.data import loaders as jload
from tcnerf.data import prefetch as jprefetch
from tcnerf.data import synthetic as jsynth
from tcnerf.models import grasp as jgrasp
from tcnerf.models import pipeline as jpipeline
from tcnerf.nn import mlp as jmlp
from tcnerf.utils import logging as jlogging
from tcnerf.utils import native
from tcnerf.utils import profiling as jprofiling
from tcnerf_torch.clip import demo, model as clip_model, tokenizer
from tcnerf_torch.core import render
from tcnerf_torch.data import dataset, generators, loaders
from tcnerf_torch.data.prefetch import GeneratorFeeder
from tcnerf_torch.models import checkpoint as ckpt
from tcnerf_torch.models import pipeline
from tcnerf_torch.nn import ResNetMLPEmbedding
from tcnerf_torch.params import from_flax, init_params, to_flax
from tcnerf_torch.utils import profiling
from tcnerf_torch.utils.logging import logger

CPU = torch.device("cpu")


def _rel_close(got, want, rtol):
    """max |got - want| <= rtol x max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("complete_output,embed_dir", [
    (False, False), (True, False), (True, True)])
def test_resnet_mlp_embedding_matches_flax(complete_output, embed_dir):
    """The single-view MLP on the flax tree (`from_flax`, and `to_flax`
    back bit for bit): its last activation, or every activation with
    `complete_output`, within 1e-6 x max |flax|."""
    rng = np.random.default_rng(3)
    pos, dirs = (rng.uniform(-1, 1, (64, 3)).astype(np.float32)
                 for _ in range(2))
    feats = rng.normal(size=(64, 20)).astype(np.float32)
    kw = dict(n_blocks=2, hidden_size=32, complete_output=complete_output,
              embed_direction_vector=embed_dir)
    fm = jmlp.ResNetMLPEmbedding(**kw)
    variables = _init(fm, pos, dirs, feats)
    m = ResNetMLPEmbedding(20, **kw)
    m.load_state_dict(from_flax(variables["params"]), strict=True)
    back = to_flax(m)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           variables["params"])
    want = _apply(fm, variables, pos, dirs, feats)
    with torch.no_grad():
        got = m(*(torch.as_tensor(x) for x in (pos, dirs, feats)))
    if not complete_output:
        got, want = [got], [want]
    assert len(got) == len(want) == (3 if complete_output else 1)
    for g, w in zip(got, want):
        _rel_close(g, w, 1e-6)


def test_resnet_mlp_embedding_init_is_flax_kind():
    """Seeded init: glorot-uniform blocks (bounded by their limit), as the
    flax module's `ResNetMLPBlock` initialiser, lecun-normal layer_0."""
    m = ResNetMLPEmbedding(20, n_blocks=2, hidden_size=32)
    init_params(m, torch.Generator().manual_seed(0))
    w = m.block_1.layer_1.weight.detach()
    assert float(w.abs().max()) <= np.sqrt(6 / 64)
    assert m.layer_0.weight.shape == (32, 60 + 3 + 20)


@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 64)])
def test_sigma_to_alpha_matches_jax(shape):
    """alpha = 1 - exp(-dist * relu(sigma)) within 1e-6 x max |jax|, and
    volumetric_render still the JAX compositing on the same inputs."""
    rng = np.random.default_rng(4)
    sigma = rng.normal(size=shape).astype(np.float32) * 5
    dists = rng.uniform(0, 0.1, shape).astype(np.float32)
    want = jrender.sigma_to_alpha(jnp.asarray(sigma), jnp.asarray(dists))
    got = render.sigma_to_alpha(torch.as_tensor(sigma),
                                torch.as_tensor(dists))
    _rel_close(got, want, 1e-6)
    assert float(got[torch.as_tensor(sigma) < 0].abs().max()) == 0.0
    zs = np.sort(rng.uniform(0.5, 2, shape), axis=-1).astype(np.float32)
    rgb = rng.uniform(size=shape + (3,)).astype(np.float32)
    outs = jrender.volumetric_render(*(jnp.asarray(x)
                                       for x in (zs, sigma, rgb)))
    got = render.volumetric_render(*(torch.as_tensor(x)
                                     for x in (zs, sigma, rgb)))
    for g, w in zip(got, outs):
        _rel_close(g, w, 1e-6)


# ------------------------------------------------------------------ data

def _generators(path, monkeypatch):
    monkeypatch.setattr(native, "load", lambda build=True: None)
    loaders.ensure_dataset(path, 4, n_samples=3, image_size=(12, 16))
    kw = dict(n_rays_train=8, batch_size=1, n_views=1, shuffle=True, rng=2)
    return (generators.MVNeRFDataGenerator(
                loaders.load_dataset_nerf(4, path), **kw),
            jgen.MVNeRFDataGenerator(jload.load_dataset_nerf(4, path), **kw),
            lambda: generators.MVNeRFDataGenerator(
                loaders.load_dataset_nerf(4, path), **kw))


def _flat(batch):
    inputs, labels = batch
    return [np.asarray(x) for x in tuple(inputs) + (labels,)]


@pytest.mark.parametrize("n_epochs", [1, 2])
def test_generator_feeder_matches_jax_and_plain_epochs(tmp_path, monkeypatch,
                                                       n_epochs):
    """GeneratorFeeder(n_epochs) gives the JAX feeder's batches bit for
    bit, which are the plain epochs' (the shuffle between them included),
    and stops after n_epochs epochs."""
    gen, jg, fresh = _generators(str(tmp_path / "ds"), monkeypatch)
    got = [_flat(b) for b in GeneratorFeeder(gen, n_epochs, device=CPU)]
    want = [_flat(b) for b in jprefetch.GeneratorFeeder(jg, n_epochs)]
    plain_gen = fresh()
    plain = [_flat(b) for _ in range(n_epochs) for b in plain_gen.epoch()]
    assert len(got) == len(want) == len(plain) == 3 * n_epochs
    for g, w, p in zip(got, want, plain):
        for a, b, c in zip(g, w, p):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_generator_feeder_without_n_epochs_is_endless(tmp_path, monkeypatch):
    """n_epochs None: the epochs go on (here past 3), and closing the
    iterator stops its producer thread."""
    gen, _, fresh = _generators(str(tmp_path / "ds"), monkeypatch)
    feeder = GeneratorFeeder(gen, None, device=CPU)
    before = threading.active_count()
    it = iter(feeder)
    got = [_flat(next(it)) for _ in range(10)]
    assert threading.active_count() == before + 1
    it.close()
    assert threading.active_count() == before
    plain_gen = fresh()
    plain = [_flat(b) for _ in range(4) for b in plain_gen.epoch()][:10]
    for g, p in zip(got, plain):
        for a, c in zip(g, p):
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("mb,cached", [("1", [2, 3, 4, 5]), ("0", []),
                                       (None, [0, 1, 2, 3, 4, 5])])
def test_dataset_cache_mb_bounds_the_cache(tmp_path, monkeypatch, mb,
                                           cached):
    """TCNERF_DATASET_CACHE_MB (default 512): six 0.25 MiB samples read in
    turn leave the last 4 in a 1 MiB cache, none in a 0 MiB one and all
    by default; the JAX ColorDataset keeps the same ones."""
    if mb is None:
        monkeypatch.delenv("TCNERF_DATASET_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("TCNERF_DATASET_CACHE_MB", mb)
    rng = np.random.default_rng(0)
    for i in range(6):
        dataset.ColorDataset.write_sample(
            str(tmp_path), i, rng.integers(0, 255, (2, 128, 256, 4),
                                           dtype=np.uint8))
    ours = dataset.ColorDataset(str(tmp_path))
    theirs = jdataset.ColorDataset(str(tmp_path))
    for i in range(6):
        np.testing.assert_array_equal(ours.read_sample(i),
                                      theirs.read_sample(i))
    assert list(ours._cache) == list(theirs._cache) == cached
    assert ours._cache_bytes == len(cached) * 2 ** 18
    assert ours._cache_bytes <= ours._cache_budget


# ------------------------------------------------------- profiling, log

def test_timed_sink_and_default_log():
    """timed(label, sink) calls sink(label, seconds) as the JAX one does;
    without a sink it logs `<label>: <ms> ms` through the logger."""
    seen, jseen = [], []
    with profiling.timed("a", lambda *a: seen.append(a)):
        torch.ones(4).sum()
    with jprofiling.timed("a", lambda *a: jseen.append(a)):
        pass
    assert [s[0] for s in seen] == [s[0] for s in jseen] == ["a"]
    assert seen[0][1] > 0
    buf = io.StringIO()
    logger.remove()
    logger.add(buf, level="INFO")
    try:
        with profiling.timed("scope"):
            pass
    finally:
        logger.remove()
        logger.add(None)
    line = buf.getvalue().strip()
    assert "| INFO    | scope: " in line and line.endswith(" ms")


def test_benchmark_calls_and_mean():
    """benchmark runs warmup + iters calls, as the JAX one, and returns the
    mean seconds of the timed ones."""
    calls, jcalls = [], []
    t = profiling.benchmark(lambda x: calls.append(x), 1, iters=5, warmup=2)
    jprofiling.benchmark(lambda x: jcalls.append(x) or jnp.ones(1), 1,
                         iters=5, warmup=2)
    assert len(calls) == len(jcalls) == 7 and 0 <= t < 1


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(logdir) on the CPU writes one Chrome trace file into logdir
    that holds the scope's operators."""
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.listdir(tmp_path / "tr") == [os.path.basename(prof.trace_path)]
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


@pytest.mark.parametrize("level", ["INFO", "DEBUG", "ERROR"])
def test_logger_surface_matches_jax(level):
    """remove / add(sink, level) / debug / info / warning / error write the
    JAX logger's lines (timestamps aside) to the added sink."""
    lines = []
    for lg in (logger, jlogging.logger):
        buf = io.StringIO()
        lg.remove()
        lg.add(buf, level=level)
        try:
            lg.debug("d")
            lg.info("i")
            lg.warning("w")
            lg.error("e")
        finally:
            lg.remove()
        lines.append([ln[19:] for ln in buf.getvalue().splitlines()])
    logger.add(None)
    jlogging.logger.add(__import__("sys").stderr, level="INFO")
    assert lines[0] == lines[1]
    assert len(lines[0]) == {"DEBUG": 4, "INFO": 3, "ERROR": 1}[level]


# ----------------------------------------------------------------- demos

def test_clip_demo_images_and_logits_match_jax():
    """The demo's three scenes are the JAX demo's images bit for bit, and
    its logits (100 x cosine of the towers' embeddings) on tiny towers
    holding the same weights within 1e-5 x max |jax|."""
    size = 32
    images = demo.demo_images(size)
    cfg = jsynth.camera_ring(1, height=size, width=size)[0]
    want_images = np.stack([jsynth.SyntheticScene.random(
        s, n_spheres=2).render(cfg["pose"], cfg["intrinsics"].reshape(3, 3),
                               size, size)[..., :3] / 255.0
        for s in (0, 1, 2)]).astype(np.float32)
    np.testing.assert_array_equal(images, want_images)
    tokens = tokenizer.tokenize(demo.TEXTS)
    vkw = dict(layers=(1, 1, 1, 1), width=8, output_dim=32, heads=4)
    tkw = dict(width=32, heads=4, n_layers=2, output_dim=32)
    jv, jt = jclip.CLIPVisualEncoder(**vkw), jclip.CLIPTextualEncoder(**tkw)
    pre = jpreprocess(jnp.asarray(images), size)
    vp = _init(jv, pre)["params"]
    tp = _init(jt, jnp.asarray(tokens), seed=1)["params"]
    img = _apply(jv, {"params": vp}, pre)[0]
    txt = _apply(jt, {"params": tp}, jnp.asarray(tokens))
    img = img / jnp.linalg.norm(img, axis=-1, keepdims=True)
    txt = txt / jnp.linalg.norm(txt, axis=-1, keepdims=True)
    want = 100.0 * img @ txt.T
    pv = clip_model.CLIPVisualEncoder(image_size=size, **vkw)
    pv.load_state_dict(from_flax(vp), strict=True)
    pt = clip_model.CLIPTextualEncoder(**tkw)
    pt.load_state_dict(from_flax(tp), strict=True)
    with torch.no_grad():
        got = demo.similarity_logits(
            pv.eval(), pt.eval(), torch.as_tensor(images),
            torch.as_tensor(tokens.astype(np.int64)), size)
    assert tuple(got.shape) == (3, 3)
    _rel_close(got, want, 1e-5)


def test_clip_demo_main_prints_probabilities(capsys):
    """`python -m tcnerf_torch.clip.demo --size 32 --device cpu`: full-size
    random towers, the notice, three rows of three probabilities that sum
    to 1."""
    probs = demo.main(["--size", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "random towers" in out
    assert out.count("  image ") == 3 and probs.shape == (3, 3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)


def test_pipeline_demo_runs_seeded_and_from_checkpoints(tmp_path, capsys):
    """`_demo()` on the CPU: 64 guesses refined, the top 5 with finite
    energies, best first; `_demo(model_dir)` serves the grasp files of
    another seed's model, so its energies are that model's."""
    first = pipeline._demo(device="cpu")
    out = capsys.readouterr().out
    assert "refined 64 guesses" in out and out.count("energy=") == 5
    assert len(first.poses) == 5 and np.isfinite(first.all_energies).all()
    assert first.scores == sorted(first.scores, reverse=True)
    again = pipeline._demo(device="cpu")
    np.testing.assert_array_equal(again.all_energies, first.all_energies)
    other = pipeline.GraspEBM(n_views=1, n_features=32,
                              original_image_size=(48, 64), n_5d_poses=3,
                              n_blocks=2, hidden_size=32, vit_size=(32, 32),
                              vit_dim=32, vit_heads=2, vit_hooks=(1, 2, 3, 4))
    init_params(other, torch.Generator().manual_seed(1))
    ckpt.store(str(tmp_path / "model_final"), other, ckpt.GRASP_COMPONENTS)
    loaded = pipeline._demo(str(tmp_path), device="cpu")
    assert np.isfinite(loaded.all_energies).all()
    assert not np.array_equal(loaded.all_energies, first.all_energies)


def test_pipeline_demo_from_checkpoints_matches_jax(tmp_path, monkeypatch,
                                                    capsys):
    """Both packages' `_demo(model_dir)` on the same files (a seeded model
    stored by the port in the flax-msgpack layout both read): the scene
    and camera given to `infer` bit for bit, the pipelines' knobs equal.
    The demo's 64 guesses and 4 ascent steps are run from each demo's
    pipeline in f64 on both sides (the
    numpy-drawn guesses of `rng=0`, the JAX ones cast to f64): every
    energy 1e-3 relative. In f32 the ascent is compared nowhere in the
    suite: Adam's first step is a sign step, so a gradient entry near zero
    whose f32 sign differs between the packages moves a guess by twice
    the learning rate (tests/test_torch_grasp.py, the pose optimizer)."""
    model = pipeline.GraspEBM(n_views=1, n_features=32,
                              original_image_size=(48, 64), n_5d_poses=3,
                              n_blocks=2, hidden_size=32, vit_size=(32, 32),
                              vit_dim=32, vit_heads=2, vit_hooks=(1, 2, 3, 4))
    init_params(model, torch.Generator().manual_seed(1))
    ckpt.store(str(tmp_path / "model_final"), model, ckpt.GRASP_COMPONENTS)
    # the JAX `from_checkpoints` inits its tree eagerly before loading the
    # files over it; zeros of `jax.eval_shape`'s shapes give it the same
    # tree in a fraction of the time, and a leaf the files did not replace
    # would stay zero
    init = jgrasp.GraspEBM.init
    monkeypatch.setattr(jgrasp.GraspEBM, "init", lambda self, *a, **k: (
        jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                               jax.eval_shape(functools.partial(
                                   init, self, **k), *a))))
    calls = {}
    infer = {"jax": jpipeline.GraspPipeline.infer,
             "port": pipeline.GraspPipeline.infer}
    for key, cls in (("jax", jpipeline.GraspPipeline),
                     ("port", pipeline.GraspPipeline)):
        def keep(self, *args, _key=key, **kwargs):
            calls[_key] = (self, args, kwargs)
            if _key == "jax":       # its f32 ascent is not compared
                return jpipeline.GraspResult([], [], 0.0, np.zeros(0))
            return infer[_key](self, *args, **kwargs)
        monkeypatch.setattr(cls, "infer", keep)
    jpipeline._demo(str(tmp_path))
    pipeline._demo(str(tmp_path), device="cpu")
    assert capsys.readouterr().out.count("energy=") == 5
    (jpipe, jargs, jkw), (ppipe, pargs, pkw) = calls["jax"], calls["port"]
    assert jkw == pkw == {"rng": 0}
    for a, b in zip(jargs, pargs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    knobs = ("workspace_bounds", "n_initial_guesses", "n_images",
             "rotation_representation", "clip_translation",
             "n_optimization_steps", "sync", "top_k")
    assert ([getattr(jpipe, k) for k in knobs]
            == [getattr(ppipe, k) for k in knobs])
    assert (jpipe.n_initial_guesses, jpipe.n_optimization_steps) == (64, 4)
    with jax.enable_x64(True):
        j64 = dataclasses.replace(jpipe, _optimizer=None,
                                  params=jax.tree_util.tree_map(
                                      lambda a: jnp.asarray(a, jnp.float64),
                                      jpipe.params))
        jopt = j64._ensure_optimizer()
        draw = jopt.generate_initial_guesses
        jopt.generate_initial_guesses = lambda *a: [
            g.astype(np.float64) for g in draw(*a)]
        want = infer["jax"](j64, *jargs, **jkw)
    p64 = dataclasses.replace(ppipe, _optimizer=None,
                              model=copy.deepcopy(ppipe.model).double())
    got = infer["port"](p64, *pargs, **pkw)
    assert got.all_energies.shape == (64,)
    _close(got.all_energies, want.all_energies)
