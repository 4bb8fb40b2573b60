"""tcnerf_torch's grasp data and trainers against the JAX package on the
CPU: the synthetic grasp datasets and their loaders, the three grasp batch
generators, the session loop, the composed grasp configs, the backbone and
resume guards, and one tiny run of each of the four grasp entry points.

Datasets are tiny (12x16 or 48x64 renders, 5 perspectives); the JAX
generators run their numpy fallbacks (the port copies them; the host C++
library scales uint8 images in float32 instead of float64).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from test_session_loop import FakeOptimizer
from tcnerf.data import dataset as jdataset
from tcnerf.data import generators as jgen
from tcnerf.data import loaders as jload
from tcnerf.data import synthetic as jsyn
from tcnerf.train import config as jconfig
from tcnerf.train import session as jsession
from tcnerf.utils import native
from tcnerf_torch.data import dataset, generators, loaders, synthetic
from tcnerf_torch.tasks.transform import Affine
from tcnerf_torch.train import (config, grasp_common, session, train_delta_ngf,
                                train_goal, train_language, train_trajectory)

WORKSPACE = [[0.35, 0.85], [-0.25, 0.25], [0.0, 0.2]]
JCONFIGS = str(jconfig.__file__).rsplit("/", 2)[0] + "/configs"


@pytest.fixture(autouse=True)
def numpy_fallbacks(monkeypatch):
    monkeypatch.setattr(native, "load", lambda build=True: None)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """JAX-written grasp datasets, 4 scenes of 5 perspectives at 12x16: the
    delta-NGF flavour (bare records, the trajectory's order) and the
    language flavour (dict records)."""
    root = tmp_path_factory.mktemp("grasp_data")
    kw = dict(n_samples=4, n_perspectives=5, height=12, width=16, rng=2)
    jsyn.write_synthetic_dataset(str(root / "grad"), record_order=True, **kw)
    jsyn.write_synthetic_dataset(str(root / "language"), dict_records=True,
                                 **kw)
    return root


# ------------------------------------------------------------- datasets


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("flavour", [dict(dict_records=True),
                                     dict(record_order=True),
                                     dict(n_spheres=3, azimuth_span=2.0)])
def test_synthetic_grasp_dataset_matches_jax(tmp_path, flavour):
    """write_synthetic_dataset writes the JAX writer's files for one seed:
    the same names, pickles byte for byte, npz arrays bit for bit."""
    kw = dict(n_samples=2, n_perspectives=3, height=12, width=16, rng=5,
              **flavour)
    jsyn.write_synthetic_dataset(str(tmp_path / "j"), **kw)
    synthetic.write_synthetic_dataset(str(tmp_path / "p"), **kw)
    names = _tree(tmp_path / "j")
    assert names == _tree(tmp_path / "p")
    assert {n.split("/")[0] for n in names} >= {
        "color", "camera_config", "grasp_pose", "trajectory", "language",
        "info"}
    for name in names:
        a, b = tmp_path / "p" / name, tmp_path / "j" / name
        if name.endswith(".pkl"):
            assert a.read_bytes() == b.read_bytes(), name
        else:
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.keys()) == sorted(zb.keys())
                for k in za.keys():
                    np.testing.assert_array_equal(za[k], zb[k])


def test_grasp_pose_trajectory_and_colour_name_match_jax():
    rng = np.random.default_rng(4)
    scene = synthetic.SyntheticScene.random(rng)
    jscene = jsyn.SyntheticScene.random(np.random.default_rng(4))
    for i in range(4):
        np.testing.assert_array_equal(scene.grasp_pose(i),
                                      jscene.grasp_pose(i))
        for a, b in zip(synthetic.grasp_trajectory(scene.grasp_pose(i), 5),
                        jsyn.grasp_trajectory(jscene.grasp_pose(i), 5)):
            np.testing.assert_array_equal(a, b)
    for rgb in rng.uniform(size=(20, 3)):
        assert synthetic.color_name(rgb) == jsyn.color_name(rgb)


def _same_records(got, want):
    assert sorted(got.datasets) == sorted(want.datasets)
    assert len(got) == len(want)
    for key, d in got.datasets.items():
        assert type(d).__name__ == type(want.datasets[key]).__name__, key
        for i in range(len(got)):
            a, b = d.read_sample(i), want.datasets[key].read_sample(i)
            if isinstance(a, dict) and key == "grasp_pose":
                a, b = a["grasp_pose"], b["grasp_pose"]
            if isinstance(a, dict) and key == "trajectory":
                a, b = a["trajectory"], b["trajectory"]
            if key in ("camera_config",):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x["pose"], y["pose"])
            elif key in ("language",):
                assert a == b
            elif key == "info":
                assert a == b
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("loader", ["language", "baseline", "grad",
                                    "grad_order"])
def test_loaders_open_the_datasets_as_jax(datasets, loader):
    """Each loader picks the same sub-datasets, of the same kinds (pickle
    or npz), and reads the same records."""
    if loader == "language":
        got = loaders.load_dataset_language(5, str(datasets / "language"))
        want = jload.load_dataset_language(5, str(datasets / "language"))
    elif loader == "baseline":
        got = loaders.load_dataset_baseline(str(datasets), 5, "grad")
        want = jload.load_dataset_baseline(str(datasets), 5, "grad")
    else:
        kw = dict(record_grasp_pose=True, record_order=loader == "grad_order",
                  dataset_type="grad")
        got = loaders.load_dataset(str(datasets), 5, **kw)
        want = jload.load_dataset(str(datasets), 5, **kw)
    _same_records(got, want)


def test_mnpz_dataset_matches_jax(tmp_path):
    """MNPZDataset reads a monolithic npz as the JAX class does, keyed and
    whole."""
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(3, 4)), "b": rng.integers(0, 9, (3, 2))}
    path = str(tmp_path / "m" / "all.npz")
    dataset.MNPZDataset.write(path, arrays)
    for key in (None, "a"):
        got, want = (cls(path, key) for cls in (dataset.MNPZDataset,
                                                jdataset.MNPZDataset))
        assert len(got) == len(want) == 3
        for i in range(3):
            a, b = got.read_sample(i), want.read_sample(i)
            if key is None:
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(got.read_sample_at_idx(i, 1),
                                              want.read_sample_at_idx(i, 1))


# ----------------------------------------------------------- generators


def _assert_same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _two_epochs(got, want):
    assert len(got) == len(want) > 0
    for _ in range(2):
        for a, b in zip(list(got.epoch()), list(want.epoch())):
            _assert_same(a, b)


@pytest.mark.parametrize("n_views", [1, 3])
def test_grasp_generator_matches_jax(datasets, n_views):
    """GraspMVNeRFDataGenerator batches bit-equal to JAX's for one seed
    over two epochs (1 view from {3, 4}, 3 views from {0, 1, 2})."""
    kw = dict(workspace_bounds=WORKSPACE, n_views=n_views, n_points_train=16,
              batch_size=2, n_r_fraction=4, rng=3)
    path = str(datasets)
    _two_epochs(generators.GraspMVNeRFDataGenerator(
        loaders.load_dataset_baseline(path, 5, "grad"), **kw),
        jgen.GraspMVNeRFDataGenerator(
            jload.load_dataset_baseline(path, 5, "grad"), **kw))


@pytest.mark.parametrize("rep,fixed", [("quaternion", None), ("6d", None),
                                       ("quaternion", [np.pi, 0.0, 0.0])])
def test_delta_ngf_generator_matches_jax(datasets, rep, fixed):
    """DeltaNGFDataGenerator batches (landscape poses, augmented trajectory
    windows, deltas) bit-equal to JAX's over two epochs, with and without
    `fixed_orientation`."""
    kw = dict(workspace_bounds=WORKSPACE, n_views=1, batch_size=2,
              pose_augmentation_factor=4, n_future_poses=4,
              fixed_orientation=fixed, rotation_representation=rep, rng=7)
    ds = dict(record_grasp_pose=True, record_order=True, dataset_type="grad")
    got = generators.DeltaNGFDataGenerator(
        loaders.load_dataset(str(datasets), 5, **ds), **kw)
    want = jgen.DeltaNGFDataGenerator(
        jload.load_dataset(str(datasets), 5, **ds), **kw)
    assert (got.n_negative, got.n_r_negative) == (want.n_negative,
                                                   want.n_r_negative)
    _two_epochs(got, want)


def test_language_generator_matches_jax(datasets):
    """LanguageDataGenerator batches, tokens through each package's own
    tokenizer, bit-equal to JAX's over two epochs."""
    kw = dict(workspace_bounds=WORKSPACE, n_views=1, batch_size=2,
              pose_augmentation_factor=2, n_future_poses=3,
              rotation_representation="6d", rng=1)
    path = str(datasets / "language")
    got = generators.LanguageDataGenerator(
        loaders.load_dataset_language(5, path), **kw)
    want = jgen.LanguageDataGenerator(jload.load_dataset_language(5, path),
                                      **kw)
    _two_epochs(got, want)
    inputs, _ = got[0]
    assert inputs[-1].dtype == np.int32 and inputs[-1].shape == (2, 77)


# ---------------------------------------------------------- session loop


class PortFake(FakeOptimizer):
    """tests/test_session_loop.py's duck-typed pose optimizer in the port's
    shape: a prepared scene, energies as a tensor, the port's Affine."""

    def prepare(self, inputs, features):
        return inputs, features

    def optimize_pose(self, state, scene, train_config, n_steps):
        return super().optimize_pose(state, *scene, train_config, n_steps)

    def compute_current_grasp_success(self, state, scene):
        return torch.as_tensor(super().compute_current_grasp_success(
            state, *scene))

    def get_results(self, state):
        return [Affine(translation=t) for t in state["t"][0]]


def _session(module, opt, log_dir, stored):
    gt = np.eye(4)
    gt[:3, 3] = [0.5, 0.0, 0.1]

    def fit(i_epoch, e_epoch):
        opt.quality = min(1.0, opt.quality + 0.3)

    module.train_grasp_model(
        fit, stored.append, n_epochs=6, eval_after_epochs=2,
        model_log_dir=log_dir,
        model_checkpoint_name=os.path.join(log_dir, "model_final"),
        grasp_optimizer=opt,
        optimization_config={"n_optimization_steps": 2, "init_lr_t": 0.1,
                             "decay_t": 0.9, "sync": True},
        wandb_config={"project": "t", "dir": log_dir},
        valid_data=[([None] * 4, None, {"obj": {}}, gt)] * 2, rng=0)


def test_session_loop_matches_jax(tmp_path):
    """train_grasp_model with the duck-typed optimizer: the same progress
    JSON, the same pickled results (poses, energies, errors) after each
    round and the same store calls (best by score, then model_final)."""
    gt = [0.5, 0.0, 0.1]
    runs = {}
    for name, module, opt in (("j", jsession, FakeOptimizer(gt)),
                              ("p", session, PortFake(gt))):
        stored = []
        _session(module, opt, str(tmp_path / name), stored)
        runs[name] = [os.path.relpath(p, tmp_path / name) for p in stored]
    assert runs["p"] == runs["j"] and "best" in runs["p"]
    for f in ("training_progress.json",):
        assert json.loads((tmp_path / "p" / f).read_text()) == json.loads(
            (tmp_path / "j" / f).read_text())
    for epoch in (2, 4, 6):
        got, want = (pickle.loads((tmp_path / n / "valid" /
                                   f"results-{epoch}.pkl").read_bytes())
                     for n in ("p", "j"))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a["final_success"] == b["final_success"]
            assert a["errors_r"] == b["errors_r"]
            for x, y in zip(a["grasp_poses"], b["grasp_poses"]):
                np.testing.assert_array_equal(x.matrix, y.matrix)
    lines = (tmp_path / "p" / "wandb_local" / "t" /
             "wandb_log.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [2, 4, 6]


def test_session_loop_without_store_writes_the_rest(tmp_path):
    """A store_fn that writes nothing: the session still writes the
    progress and results files, and calls it for best (the first round's
    score beats the initial one) and model_final after each round."""
    opt = PortFake([0.5, 0.0, 0.1])
    stored = []
    history = session.train_grasp_model(
        lambda i, e: None, stored.append, 2, 1, str(tmp_path),
        str(tmp_path / "model_final"), opt, {"n_optimization_steps": 1},
        {"project": "t", "dir": str(tmp_path)},
        [([None] * 4, None, {}, np.eye(4))], rng=0)
    assert [e for e, _, _ in history["valid"]] == [None, 1, 2]
    assert json.loads((tmp_path / "training_progress.json").read_text())[
        "epoch"] == 2
    assert sorted(os.listdir(tmp_path / "valid")) == ["results-1.pkl",
                                                      "results-2.pkl"]
    assert stored[0] == str(tmp_path / "best")
    assert stored.count(str(tmp_path / "model_final")) == 2


def test_oracle_error_matches_jax():
    from tcnerf.tasks.agents import OracleAgent as JOracle
    from tcnerf_torch.tasks.agents import OracleAgent
    rng = np.random.default_rng(3)
    for _ in range(5):
        a = [tuple(rng.normal(size=3)), tuple(rng.normal(size=4))]
        b = [tuple(rng.normal(size=3)), tuple(rng.normal(size=4))]
        assert OracleAgent().calculate_error(a, b) == JOracle(
        ).calculate_error(a, b)


# --------------------------------------------------------------- configs

GRASP_CONFIGS = ["goal_1_view", "dngf_1_view", "trajectory_1_view-1",
                 "trajectory_1_view-2", "language_1_view"]


@pytest.mark.parametrize("name", GRASP_CONFIGS)
def test_grasp_config_matches_jax(name):
    """Each composed grasp config, bare and with overrides, equals the JAX
    composition key for key."""
    for overrides in ([], ["data_dir=/tmp/x", "grasp_training.n_epochs=2",
                           "validation.valid_sample_indices=[0,1]",
                           "+grasp_training.loss_reduction=sum"]):
        got = config.load_config(overrides, name)
        want = jconfig.load_config(JCONFIGS, name, overrides).to_dict()
        assert got == want and got.to_dict() == want


# ---------------------------------------------------------- entry points

TINY = ["nerf_model.original_image_size=[48,64]", "nerf_model.n_features=32",
        "nerf_model.vit_size=[32,32]", "nerf_model.vit_dim=32",
        "nerf_model.vit_heads=2", "nerf_model.vit_hooks=[1,2,3,4]",
        "nerf_model.n_blocks=2", "nerf_model.hidden_size=32",
        "grasp_model.n_5d_poses=3", "grasp_training.n_epochs=2",
        "grasp_training.eval_after_epochs=1", "grasp_training.batch_size=2",
        "dataset.n_perspectives=5", "dataset.n_synthetic_samples=2",
        "validation.valid_sample_indices=[0,1]",
        "validation.grasp_opt_config.optimizer_config.n_initial_guesses=8",
        "validation.grasp_opt_config.optimization_config."
        "n_optimization_steps=2",
        "generator_grasp.n_points_train=16", "generator_grasp.n_r_fraction=4",
        "generator_grasp.pose_augmentation_factor=4",
        "generator_grasp.n_future_poses=4"]
CLIP_TINY = ["nerf_model.n_features=256", "nerf_model.clip_layers=[1,1,1,1]",
             "nerf_model.clip_width=8", "nerf_model.clip_embed_dim=32",
             "nerf_model.clip_text_width=16", "nerf_model.clip_text_layers=1",
             "nerf_model.clip_image_size=32"]
# (config, trainer, extra overrides, the metric each step logs)
ENTRIES = [("goal_1_view", train_goal.run_goal_training, [], "loss"),
           ("dngf_1_view", train_delta_ngf.run_delta_training, [],
            "landscape_loss"),
           ("trajectory_1_view-2", train_trajectory.run_trajectory_training,
            [], "grad_loss_t"),
           ("language_1_view", train_language.run_language_training,
            CLIP_TINY, "grad_loss_r"),
           ("language_1_view", train_language.run_language_training,
            CLIP_TINY + ["grasp_training.train_fusion=true"], "pred")]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("entries")


@pytest.mark.parametrize("name,run,extra,metric", ENTRIES,
                         ids=["goal", "dngf", "trajectory", "language",
                              "language_fusion"])
def test_entry_point_trains_on_the_cpu(data_dir, name, run, extra, metric,
                                       tmp_path):
    """Each grasp trainer through its normal function at a tiny size on
    the CPU: datasets synthesized, two steps with finite metrics, the
    frozen backbone untouched, two validations whose results pickle, and
    the progress file. Configs reading one dataset kind share it."""
    cfg = config.load_config(TINY + extra + [
        f"data_dir={data_dir}",
        f"grasp_training.model_path={tmp_path / 'model'}"], name)
    seeded = grasp_common.build_grasp_model(
        cfg, fusion="v4" if "language" in name else None, device="cpu")
    run_ = run(cfg, device="cpu")
    steps = run_.history["steps"]
    assert len(steps) == 2 and all(np.isfinite(s[metric]) for s in steps)
    assert run_.state.step == 2
    trained = set(run_.state.names)
    moved = set()
    for (n, p), q in zip(run_.state.model.named_parameters(),
                         seeded.parameters()):
        if not torch.equal(p.detach(), q.detach()):
            moved.add(n)
    assert moved and moved <= trained
    assert any(n.startswith("combine_clip_visual") for n in trained) == (
        "grasp_training.train_fusion=true" in extra)
    model_dir = tmp_path / "model"
    progress = json.loads((model_dir / "training_progress.json").read_text())
    assert progress["epoch"] == 2 and len(progress["best_mean_error"]) == 2
    for epoch in (1, 2):
        with open(model_dir / "valid" / f"results-{epoch}.pkl", "rb") as f:
            results = pickle.load(f)
        assert len(results) == 2 and len(results[0]["errors_r"]) == 5
    assert [e for e, _, _ in run_.history["valid"]] == [None, 1, 2]
    extra = ("combine_clip_visual",) if "language" in name else ()
    assert sorted(f for f in os.listdir(model_dir)
                  if f.endswith(".msgpack")) == sorted(
        f"{kind}_{c}.msgpack" for kind in ("best", "model_final")
        for c in ("fine_embedding", "visual_features", "grasp_readout")
        + extra)
    # the rerun resumes: model_final loads, no round is left to train
    again = run(cfg, device="cpu")
    assert again.history["steps"] == []
    assert [e for e, _, _ in again.history["valid"]] == [None]
    for (n, p), q in zip(again.state.model.named_parameters(),
                         run_.state.model.parameters()):
        assert torch.equal(p.detach(), q.detach()), n


# -------------------------------------------------------- backbone guard


class _JState:
    """What tcnerf's load_backbone / resume_or_init read of a train state."""

    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _JState(params)


def test_backbone_and_resume_guards(tmp_path, caplog):
    """load_backbone and resume_or_init on files the JAX package wrote
    (`tcnerf.models.checkpoint.store`, `store_meta`), branch for branch
    against tcnerf/train/grasp_common.py on the same files and the same
    tiny language model: the same loaded / not-loaded outcome and weights
    (bit for bit), the same errors by type, and a warning where JAX
    warns. Branches: no backbone (seeded, or FileNotFoundError under
    require_backbone); the bare backbone; under fusion no decoder file, a
    decoder of other keys (ValueError caught), a matching one, a sidecar of
    fusion "without", of the wrong flavour (ValueError under
    require_backbone) and of the language flavour; resume without files,
    with the grasp components alone and with the decoder too."""
    from tcnerf.models import checkpoint as jckpt
    from tcnerf.train import grasp_common as jcommon
    from tcnerf_torch.params import from_flax, to_flax
    base = TINY + CLIP_TINY + [f"data_dir={tmp_path}"]
    cfg = config.load_config(base, "language_1_view")
    strict = config.load_config(
        base + ["+grasp_training.require_backbone=true"], "language_1_view")
    comps = ("fine_embedding", "visual_features", "combine_clip_visual",
             "grasp_readout")
    source = grasp_common.build_grasp_model(
        config.load_config(base + ["seed=5"], "language_1_view"),
        fusion="v4", device="cpu")
    files = {c: to_flax(getattr(source, c)) for c in comps}
    backbone = os.path.join(cfg.grasp_training.backbone_path, "model_final")
    final = os.path.join(cfg.grasp_training.model_path, "model_final")

    def run(fn, fusion=None):
        """fn in both packages on fresh models: (loaded, the components
        that now hold the files' weights, whether the port warned)."""
        model = grasp_common.build_grasp_model(cfg, fusion="v4",
                                               device="cpu")
        jstate = _JState({k: to_flax(getattr(model, k)) for k in comps})
        caplog.clear()
        with caplog.at_level("INFO"):
            if fn == "backbone":
                m, loaded = grasp_common.load_backbone(model, cfg, fusion)
                jstate, jloaded = jcommon.load_backbone(jstate, cfg, fusion)
                assert m is model and loaded == jloaded
            else:
                assert grasp_common.resume_or_init(
                    model, cfg, ("combine_clip_visual",)) is model
                jstate = jcommon.resume_or_init(jstate, cfg,
                                                ("combine_clip_visual",))
                loaded = None
        which = set()
        for k in comps:
            got = getattr(model, k).state_dict()
            want = from_flax(jstate.params[k], dtype=None)
            assert all(torch.equal(got[n], want[n]) for n in want), k
            if all(torch.equal(got[n], v) for n, v in
                   from_flax(files[k], dtype=None).items()):
                which.add(k)
        warned = any(r.levelname == "WARNING" for r in caplog.records)
        return loaded, which, warned

    def both_raise(error, match, *args):
        model = grasp_common.build_grasp_model(cfg, fusion="v4",
                                               device="cpu")
        jstate = _JState({k: to_flax(getattr(model, k)) for k in comps})
        for fn, state in ((grasp_common.load_backbone, model),
                          (jcommon.load_backbone, jstate)):
            with pytest.raises(error, match=match):
                fn(state, strict, *args)

    bare = {"fine_embedding", "visual_features"}
    assert run("backbone", False) == (False, set(), True)
    assert run("backbone", True) == (False, set(), True)
    both_raise(FileNotFoundError, "require_backbone")
    jckpt.store(backbone, files, ("fine_embedding", "visual_features"))
    assert run("backbone", False) == (True, bare, False)
    assert run("backbone", True) == (True, bare, True)
    jckpt.store(backbone, {"combine_clip_visual": files["fine_embedding"]},
                ("combine_clip_visual",))
    assert run("backbone", True) == (True, bare, True)
    jckpt.store(backbone, files, ("combine_clip_visual",))
    assert run("backbone", True) == (True, bare | {"combine_clip_visual"},
                                     False)
    flavour = {"fusion": "v4", "fusion_use_dense": True,
               "fusion_activation": "elu", "field": "pixel"}
    for meta, want in (({"fusion": "without"}, (True, bare, True)),
                       ({"fusion_use_dense": False,
                         "fusion_activation": "relu"}, (True, bare, True)),
                       ({}, (True, bare | {"combine_clip_visual"}, False))):
        jckpt.store_meta(backbone, {**flavour, **meta})
        assert run("backbone", True) == want, meta
    jckpt.store_meta(backbone, {**flavour, "fusion_activation": "relu"})
    both_raise(ValueError, "flavor", True)
    assert run("resume") == (None, set(), False)
    jckpt.store(final, files, ("fine_embedding", "visual_features",
                               "grasp_readout"))
    assert run("resume") == (None, set(comps) - {"combine_clip_visual"},
                             False)
    jckpt.store(final, files, ("combine_clip_visual",))
    assert run("resume") == (None, set(comps), False)
