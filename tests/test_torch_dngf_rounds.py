"""Whole rounds of the delta-NGF trainer against the JAX package's, in f64
on the CPU: both packages' `run_delta_training` end to end, from one
parameter tree.

`dngf_convergence_cpu` at the tiny widths of
tests/test_torch_grasp_convergence.py (`TINY`) on 4 scenes, batch 2, 4
epochs with a validation after every 2: 8 steps over 3 epoch boundaries
(the generator's shuffles) and 2 rounds of validation by synchronized
ascent (8 guesses, 2 steps), each scored, pickled, compared with the best
so far and stored. The trainers run as they are; the test only
- gives both the same tree: a flax tree filled from a numpy seed, in
  f64, as the JAX trainer's initial state and, through `from_flax`, the
  port model's (no backbone file exists, so both keep it whole);
- feeds the JAX generator's images through its numpy u8 -> f32 path,
  which is the port's (its native one rounds 1 ulp otherwise);
- runs the JAX side under x64 with an f64 attention softmax and f64
  initial guesses in its ascent (the port's ascent takes the model's
  dtype);
- casts both packages' f32 batches to f64 on their way to the step, and
  gives JAX's validation features f64 copies of the f32 images, as the
  port's `make_compute_features` does. JAX promotes per operation, so an
  operation on f32 inputs alone stays f32 under f64 parameters: without
  the casts the packages part at 2e-6 (the first step's landscape loss,
  through JAX's f32 pose matrices) and 5e-9 (the validation features)
  (`test_jax_keeps_f32_only_operations_in_f32`);
- records each package's step metrics and checkpoint stores.

Held at 1e-8 relative: every step's four metrics, each round's
`log_results` dict and each sample's five scored poses' errors and
energies, the best mean error in `training_progress.json`, the order of
`best` / `model_final` stores (so the same rounds are stored as best),
and the readout read back from both `best` and `model_final` files (1e-8
of each tensor's largest entry). Both packages agree to about 1e-11
here; no entry needs excluding. The last case drives
`scripts/round_parity.py` (a round of the port from one start on several
devices and dtypes) at the same size on the CPU.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcnerf.train.train_delta_ngf as jtrain
from test_torch_fusion import _fill
from test_torch_grasp_convergence import ROOT, TINY, _rel, _script
from test_torch_grasp_train import _f64_attention
from tcnerf.models import checkpoint as jckpt
from tcnerf.models import grasp_training as JGT
from tcnerf.opt import pose_optimizer as jpose
from tcnerf.train import config as jconfig
from tcnerf.train import grasp_common as JG
from tcnerf.train import session as jsession
from tcnerf.utils import native as jnative
from tcnerf_torch.models import checkpoint as ckpt
from tcnerf_torch.params import from_flax
from tcnerf_torch.train import config, grasp_common, train_delta_ngf

NAME = "dngf_convergence_cpu"
ROUNDS = ["dataset.n_synthetic_samples=4", "grasp_training.n_epochs=4",
          "grasp_training.eval_after_epochs=2"]
BAR = 1e-8
METRICS = ("landscape_loss", "grad_loss_t", "grad_loss_r", "pred")
round_parity = _script("round_parity")


def _f64(x):
    x = np.asarray(x)
    return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x


def _tree(jcfg):
    """The flax parameter tree of the config's model, filled from
    `np.random.default_rng(3)`."""
    model = JG.build_grasp_model(jcfg)
    h, w = jcfg.nerf_model.original_image_size
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.tile(jnp.eye(4), (2, 2, 1, 1)),
        jnp.zeros((2, 1, h, w, 3)), jnp.zeros((2, 1, 4, 4)),
        jnp.zeros((2, 1, 4, 4)), method="init_all"))["params"]
    return _fill(shapes, np.random.default_rng(3))


def _recorder(log, fn, pick):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        log.append(pick(a, out))
        return out
    return wrapped


def _run_jax(mp, cfg, tree):
    """The JAX trainer from `tree` in f64: (step metrics, logged rounds,
    stored checkpoint names)."""
    steps, logged, stores = [], [], []
    draw = jpose.PoseOptimizer.generate_initial_guesses
    feed = jtrain.prefetched_epochs

    def feed64(*a, **kw):
        for inputs, labels in feed(*a, **kw):
            yield [_f64(x) for x in inputs], [_f64(y) for y in labels]

    mp.setattr(jtrain, "prefetched_epochs", feed64)
    mp.setattr(JG, "make_compute_features", lambda model, state, tok=None: (
        lambda obs, tokens: model.apply(
            {"params": state.params},
            np.asarray(obs, np.float32).astype(np.float64), tokens,
            method="compute_features")))
    mp.setattr(jnative, "u8_to_f32_rgb",
               lambda image: (image[..., :3] / 255.0).astype(np.float32))
    mp.setattr(jtrain, "init_grasp_state",
               lambda model, cfg, inputs, seed=0, trainable=(
                   "grasp_readout",): JGT.create_grasp_train_state(
                   model, jax.tree_util.tree_map(
                       lambda a: jnp.asarray(a, jnp.float64), tree),
                   cfg.grasp_training.learning_rate, trainable))
    mp.setattr(jpose.PoseOptimizer, "generate_initial_guesses",
               lambda self, *a, **kw: [g.astype(np.float64)
                                       for g in draw(self, *a, **kw)])
    mp.setattr(JGT, "delta_ngf_train_step", _recorder(
        steps, JGT.delta_ngf_train_step,
        lambda a, out: {k: float(v) for k, v in out[1].items()}))
    mp.setattr(jsession, "log_results", _recorder(
        logged, jsession.log_results, lambda a, out: out))
    mp.setattr(jckpt, "store", _recorder(
        stores, jckpt.store, lambda a, out: os.path.basename(a[0])))
    with _f64_attention():
        jtrain.run_delta_training(cfg, sync=True)
    return steps, logged, stores


def _run_port(mp, cfg, tree):
    """The port's trainer from `tree` in f64 (scripts/round_parity.py's
    `float64`: the model and batches in f64): (GraspRun, stored
    checkpoint names)."""
    stores = []
    init = grasp_common.init_grasp_state

    def init_from_tree(model, cfg, trainable=("grasp_readout",)):
        model.load_state_dict(from_flax(tree, np.float64), strict=True)
        return init(model, cfg, trainable)

    mp.setattr(train_delta_ngf, "init_grasp_state", init_from_tree)
    mp.setattr(ckpt, "store", _recorder(
        stores, ckpt.store, lambda a, out: os.path.basename(a[0])))
    with round_parity.float64():
        return train_delta_ngf.run_delta_training(cfg), stores


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers on one dataset and tree: {"jax": (steps, logged,
    stores, model_path), "port": (GraspRun, stores, model_path), "tree":
    the initial flax tree}."""
    root = tmp_path_factory.mktemp("dngf_rounds")
    common = [f"data_dir={root}", *TINY, *ROUNDS]
    paths = {k: str(root / k) for k in ("jax", "port")}
    jcfg = jconfig.load_config(ROOT, NAME, [
        *common, f"grasp_training.model_path={paths['jax']}"])
    pcfg = config.load_config(["device=cpu", *common,
                               f"grasp_training.model_path={paths['port']}"],
                              NAME)
    tree = _tree(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        jax_out = _run_jax(mp, jcfg, tree)
    with pytest.MonkeyPatch.context() as mp:
        port_out = _run_port(mp, pcfg, tree)
    return {"jax": (*jax_out, paths["jax"]),
            "port": (*port_out, paths["port"]), "tree": tree}


def test_every_step_matches_jax(runs):
    """8 steps, each one's four metrics at 1e-8 relative."""
    steps = runs["jax"][0]
    got = runs["port"][0].history["steps"]
    assert len(steps) == len(got) == 8
    for i, (want, have) in enumerate(zip(steps, got)):
        for k in METRICS:
            assert _rel(have[k], want[k]) <= BAR, (i, k, have[k], want[k])


def test_every_round_matches_jax(runs):
    """2 rounds: `log_results`' dict, and in the pickled results each
    sample's five scored poses' oracle errors and final energies, at 1e-8
    relative."""
    logged, jpath = runs["jax"][1], runs["jax"][3]
    run, ppath = runs["port"][0], runs["port"][2]
    rounds = [d for e, d, _ in run.history["valid"] if e is not None]
    assert [d["epoch"] for d in logged] == [d["epoch"] for d in rounds] \
        == [2, 4]
    for want, have in zip(logged, rounds):
        for k, v in want.items():
            if k != "epoch":
                assert _rel(have[k], v) <= BAR, (want["epoch"], k)
        results = []
        for path in (jpath, ppath):
            with open(os.path.join(path, "valid",
                                   f"results-{want['epoch']}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        assert len(results[0]) == len(results[1]) == 2
        for a, b in zip(*results):
            assert _rel(b["errors_r"], a["errors_r"]) <= BAR
            assert _rel(b["final_success"], a["final_success"]) <= BAR


def test_best_round_and_stores_match_jax(runs):
    """The same stores in the same order (`best` after a round that beats
    every earlier one, `model_final` after each), and the same best mean
    error in `training_progress.json` at 1e-8."""
    jstores, jpath = runs["jax"][2], runs["jax"][3]
    pstores, ppath = runs["port"][1], runs["port"][2]
    assert jstores == pstores
    assert jstores.count("model_final") == 2 and "best" in jstores
    progress = []
    for path in (jpath, ppath):
        with open(os.path.join(path, "training_progress.json")) as f:
            progress.append(json.load(f))
    assert progress[0]["epoch"] == progress[1]["epoch"] == 4
    assert _rel(progress[1]["best_mean_error"],
                progress[0]["best_mean_error"]) <= BAR


@pytest.mark.parametrize("name", ["best", "model_final"])
def test_stored_readout_matches_jax(runs, name):
    """The readout read back from each package's `<name>` files: each
    tensor at 1e-8 of its largest entry."""
    jpath, run, ppath = runs["jax"][3], runs["port"][0], runs["port"][2]
    stored = jckpt.load(os.path.join(jpath, name),
                        {"grasp_readout": runs["tree"]["grasp_readout"]},
                        ("grasp_readout",))
    assert stored is not None
    want = from_flax({"grasp_readout": stored["grasp_readout"]}, np.float64)
    model = run.state.model
    assert ckpt.load(os.path.join(ppath, name), model, ("grasp_readout",))
    got = {n: p.detach().numpy() for n, p in model.named_parameters()
           if n.startswith("grasp_readout.")}
    assert got and set(got) == set(want)
    for n, value in got.items():
        assert _rel(value, want[n].numpy()) <= BAR, n


def test_jax_keeps_f32_only_operations_in_f32(runs):
    """Why the test casts the inputs: JAX's f64 `compute_features` of the
    f32 validation images parts from that of their f64 copies by more than
    1e-10 relative (its image operations before the first parameter stay
    f32), while the port's, which carries the images in the model's
    dtype, equals the latter at 1e-12."""
    jcfg = jconfig.load_config(ROOT, NAME, [*TINY])
    model = JG.build_grasp_model(jcfg)
    h, w = jcfg.nerf_model.original_image_size
    images = np.random.default_rng(4).random((1, 2, h, w, 3)).astype(
        np.float32)
    port = runs["port"][0].state.model
    with torch.no_grad():
        got = port.compute_features(torch.as_tensor(images).double()).numpy()
    with _f64_attention():
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), runs["tree"])
        f32, f64 = (np.asarray(model.apply(
            {"params": params}, x, None, method="compute_features"))
            for x in (images, images.astype(np.float64)))
    assert f32.dtype == f64.dtype == np.float64
    assert _rel(f32, f64) > 1e-10
    assert _rel(got, f64) <= 1e-12


def test_round_parity_tool_on_the_cpu(tmp_path, capsys):
    """`scripts/round_parity.py` at the tiny widths, 2 epochs as one round
    from one start, in f32 on 1 and 2 CPU threads and in f64: each run's
    4 steps and round written; the first step's metrics, since every run
    resumes the same stored start, within f32 rounding of each other:
    1e-5 relative between the f32 runs, 1e-3 from the f64 run (the
    delta-NGF cosine losses are ill-conditioned in f32); each later run
    printed against the first of its dtype."""
    overrides = [f"data_dir={tmp_path}", *TINY,
                 "dataset.n_synthetic_samples=4"]
    cfg = config.load_config(["device=cpu", *overrides], NAME)
    source = grasp_common.build_grasp_model(cfg, device="cpu")
    ckpt.store(os.path.join(cfg.grasp_training.backbone_path, "model_final"),
               source, ckpt.BACKBONE_COMPONENTS)
    threads = torch.get_num_threads()
    try:
        assert round_parity.main([
            "--out", str(tmp_path / "rp"), "--epochs", "2", "--runs",
            "cpu:float32:1,cpu:float32:2,cpu:float64:1", *overrides]) == 0
    finally:
        torch.set_num_threads(threads)
    records = []
    for name in ("cpu_float32_t1", "cpu_float32_t2", "cpu_float64_t1"):
        with open(tmp_path / "rp" / f"{name}.json") as f:
            records.append(json.load(f))
    for record in records:
        assert len(record["steps"]) == 4 and len(record["errors"]) == 2
        assert set(record["round"]) >= {"best_r_error_mean_t"}
        bar = 1e-5 if record["dtype"] == "float32" else 1e-3
        for k in METRICS:
            assert _rel(record["steps"][0][k],
                        records[0]["steps"][0][k]) <= bar, (record["name"], k)
    out = capsys.readouterr().out
    assert "cpu_float32_t2 against cpu_float32_t1" in out
    assert "cpu_float64_t1 against" not in out
    assert "of the round's largest change" in out
