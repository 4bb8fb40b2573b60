"""tcnerf_torch's grasp-stage trained-quality tooling against the JAX
package on the CPU: `tools/convergence.py` `strong_validate` against the
JAX strong-ascent validation (tools/strong_goal_validation.py's calls,
with its overrides and rng) on the same checkpoint files, the round
reader against the session's `log_results`, `--fit`'s dispatch to each
family's trainer and the controlled bar's exit code.

Sizes are the grasp tests' tiny widths (48x64, ViT 32 at 32^2, 2 blocks of
32, n_features 32, 3 5-d poses): a backbone stored from seeded weights,
a `goal_convergence_cpu` and a `dngf_convergence_cpu` run of 2 epochs on
2 scenes, each validated on samples 0 and 1 with 8 guesses and 2 steps.
The strong validation takes 8 guesses and 2 steps. Bars: those of
tests/test_torch_grasp.py, both sides in f64 (the JAX side with an f64
attention softmax): oracle errors 1e-4 absolute (metres, radians; the
pose bar), energies 1e-3 relative; the reader's numbers are
`log_results`' to 1e-12 relative.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fusion import _fill
from test_torch_grasp_train import _f64_attention
from tcnerf.data import generators as jgenerators
from tcnerf.data import loaders as jloaders
from tcnerf.models import checkpoint as jckpt
from tcnerf.models import grasp_training as JGT
from tcnerf.train import config as jconfig
from tcnerf.train import grasp_common as JG
from tcnerf.train import session as jsession
from tcnerf_torch.data import generators, loaders
from tcnerf_torch.models import checkpoint as ckpt
from tcnerf_torch.models import grasp_training as GT
from tcnerf_torch.params import from_flax, init_params
from tcnerf_torch.tools import convergence
from tcnerf_torch.train import (config, grasp_common, session,
                                train_delta_ngf, train_goal, train_language,
                                train_nerf, train_trajectory)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.join(REPO, "tcnerf", "configs")


def _script(name):
    """The module of `scripts/<name>.py`."""
    spec = importlib.util.spec_from_file_location(
        f"scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TINY = ["nerf_model.original_image_size=[48,64]", "nerf_model.n_features=32",
        "nerf_model.vit_size=[32,32]", "nerf_model.vit_dim=32",
        "nerf_model.vit_heads=2", "nerf_model.vit_hooks=[1,2,3,4]",
        "nerf_model.n_blocks=2", "nerf_model.hidden_size=32",
        "grasp_model.n_5d_poses=3", "grasp_training.n_epochs=2",
        "grasp_training.eval_after_epochs=1", "dataset.n_synthetic_samples=2",
        "validation.valid_sample_indices=[0,1]",
        "validation.grasp_opt_config.optimizer_config.n_initial_guesses=8",
        "validation.grasp_opt_config.optimization_config."
        "n_optimization_steps=2",
        "generator_grasp.n_points_train=16", "generator_grasp.n_r_fraction=4",
        "generator_grasp.pose_augmentation_factor=4",
        "generator_grasp.n_future_poses=4"]
STRONG = dict(n_guesses=8, n_steps=2)
FAMILIES = ["goal_convergence_cpu", "dngf_convergence_cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """config -> (overrides, model_path, backbone_path, GraspRun): a
    backbone stored from weights seeded 5, then 2 epochs of the config's
    trainer on it."""
    root = tmp_path_factory.mktemp("grasp_convergence")
    out = {}
    for name in FAMILIES:
        overrides = ["device=cpu", f"data_dir={root / name}", *TINY]
        cfg = config.load_config(overrides, name)
        backbone = cfg.grasp_training.backbone_path
        source = grasp_common.build_grasp_model(cfg, device="cpu")
        init_params(source, torch.Generator().manual_seed(5))
        ckpt.store(os.path.join(backbone, "model_final"), source,
                   ckpt.BACKBONE_COMPONENTS)
        trainer = (train_goal.run_goal_training if name.startswith("goal")
                   else train_delta_ngf.run_delta_training)
        out[name] = (overrides, cfg.grasp_training.model_path, backbone,
                     trainer(cfg))
    return out


def _generators(name, cfg):
    """Both packages' training generators of the config, built and first
    drawn as the trainers build and draw them (the JAX trainer initializes
    from batch 0)."""
    wb = [list(b) for b in cfg.generator_grasp.workspace_bounds]
    if name.startswith("goal"):
        kw = dict(workspace_bounds=wb, n_views=1,
                  n_points_train=cfg.generator_grasp.n_points_train,
                  batch_size=cfg.grasp_training.batch_size,
                  n_r_fraction=cfg.generator_grasp.n_r_fraction, rng=0)
        pairs = [(jgenerators.GraspMVNeRFDataGenerator,
                  jloaders.load_dataset_baseline),
                 (generators.GraspMVNeRFDataGenerator,
                  loaders.load_dataset_baseline)]
        gens = [g(load(path=cfg.dataset.path,
                       n_perspectives=cfg.dataset.n_perspectives,
                       dataset_type="train"), **kw) for g, load in pairs]
    else:
        kw = dict(workspace_bounds=wb, n_views=1,
                  batch_size=cfg.grasp_training.batch_size,
                  pose_augmentation_factor=(
                      cfg.generator_grasp.pose_augmentation_factor),
                  n_future_poses=cfg.generator_grasp.n_future_poses,
                  rotation_representation="quaternion", rng=0)
        pairs = [(jgenerators.DeltaNGFDataGenerator, jloaders.load_dataset),
                 (generators.DeltaNGFDataGenerator, loaders.load_dataset)]
        gens = [g(load(cfg.dataset.path, cfg.dataset.n_perspectives,
                       record_grasp_pose=True, record_order=True,
                       dataset_type="train"), **kw) for g, load in pairs]
    for g in gens:
        g[0]
    return gens


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


@pytest.mark.parametrize("name", FAMILIES)
def test_fit_steps_match_jax(tmp_path, name):
    """8 steps (4 epochs of 4 scenes, batch 2) of the config's trainer
    arithmetic in both packages, f64, from one parameter tree, on each
    package's own generator drawn as its trainer draws it: every batch the
    same (the images to 1.2e-7: the JAX package's native u8 -> f32
    conversion rounds 1 ulp otherwise than its numpy fallback, which the
    port is), so the epoch-end shuffles stay in step; fed the port's batch,
    every step's metrics 1e-9 relative and the readout after the 8 steps
    1e-9 of each tensor's max (both packages agree to about 1e-11;
    tests/test_torch_dngf_rounds.py holds whole trainer rounds)."""
    cfg = config.load_config(
        ["device=cpu", f"data_dir={tmp_path}", *TINY,
         "dataset.n_synthetic_samples=4"], name)
    goal = name.startswith("goal")
    grasp_common.prepare_datasets(cfg, "goal" if goal else "grad")
    jgen, pgen = _generators(name, cfg)
    jcfg = jconfig.load_config(ROOT, name, [f"data_dir={tmp_path}", *TINY])
    fm = JG.build_grasp_model(jcfg)
    h, w = cfg.nerf_model.original_image_size
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.PRNGKey(0), jnp.tile(jnp.eye(4), (2, 2, 1, 1)),
        jnp.zeros((2, 1, h, w, 3)), jnp.zeros((2, 1, 4, 4)),
        jnp.zeros((2, 1, 4, 4)), method="init_all"))["params"]
    tree = _fill(shapes, np.random.default_rng(3))
    model = grasp_common.build_grasp_model(cfg, device="cpu")
    model.load_state_dict(from_flax(tree, np.float64), strict=True)
    model.double()
    lr = cfg.grasp_training.learning_rate
    state = GT.create_grasp_train_state(model, lr)
    loss = cfg.grasp_training.loss
    rep = cfg.grasp_model.get("rotation_representation", "quaternion")
    steps = 0
    with _f64_attention():
        jstate = JGT.create_grasp_train_state(
            fm, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       tree), lr)
        for _ in range(4):
            for (ji, jl), (pi, pl) in zip(list(jgen.epoch()),
                                          list(pgen.epoch())):
                jl, pl = ([jl], [pl]) if goal else (jl, pl)
                for a, b in zip([*ji, *jl], [*pi, *pl]):
                    np.testing.assert_allclose(a, b, rtol=0, atol=1.2e-7)
                x = [np.asarray(a, np.float64) for a in pi]
                y = [np.asarray(a, np.float64) for a in pl]
                if goal:
                    jstate, want = JGT.grasp_train_step(
                        jstate, [jnp.asarray(a) for a in x],
                        jnp.asarray(y[0]), loss, "mean")
                    got = GT.grasp_train_step(
                        state, [torch.as_tensor(a) for a in x],
                        torch.as_tensor(y[0]), loss, "mean")[1]
                else:
                    jstate, want = JGT.delta_ngf_train_step(
                        jstate, [jnp.asarray(a) for a in x],
                        [jnp.asarray(a) for a in y], loss, rep, False)
                    got = GT.delta_ngf_train_step(
                        state, [torch.as_tensor(a) for a in x],
                        [torch.as_tensor(a) for a in y], loss, rep,
                        False)[1]
                steps += 1
                for k, v in want.items():
                    assert _rel(float(got[k]), float(v)) <= 1e-9, (
                        steps, k, float(got[k]), float(v))
        readout = from_flax({"grasp_readout": jax.device_get(
            jstate.params["grasp_readout"])}, np.float64)
    assert steps == 8
    for n, p in model.named_parameters():
        if n.startswith("grasp_readout."):
            assert _rel(p.detach().numpy(), readout[n].numpy()) <= 1e-9, n


def _jax_strong(name, overrides, model_path, backbone, alternate=False):
    """The JAX strong validation of tools/strong_goal_validation.py, in
    f64: its config overrides, `build_grasp_model`, the backbone and the
    run's `best` loaded through `load_backbone` / `ckpt.load`, its pose
    optimizer, oracle, validation samples and `np.random.default_rng(0)`.
    The parameter tree takes flax init's shapes (`jax.eval_shape`) in
    place of the script's eager init, whose values the files replace; the
    delta-NGF run validates with `sync`, as its trainer does, unless
    `alternate` asks for the script's own ascent (no `sync`)."""
    prefix = "validation.grasp_opt_config."
    cfg = jconfig.load_config(ROOT, name, [
        *[o for o in overrides if not o.startswith("device=")],
        f"grasp_training.model_path={model_path}",
        f"grasp_training.backbone_path={backbone}",
        f"{prefix}optimizer_config.n_initial_guesses={STRONG['n_guesses']}",
        f"{prefix}optimization_config.n_optimization_steps="
        f"{STRONG['n_steps']}"])
    if name.startswith("goal"):
        valid = jloaders.load_dataset_baseline(
            path=cfg.dataset.path, n_perspectives=cfg.dataset.n_perspectives,
            dataset_type="valid")
    else:
        valid = jloaders.load_dataset(
            cfg.dataset.path, cfg.dataset.n_perspectives,
            record_grasp_pose=True, record_order=True, dataset_type="valid")
    model = JG.build_grasp_model(cfg)
    h, w = cfg.nerf_model.original_image_size
    eye = jnp.tile(jnp.eye(4), (1, 1, 1, 1))
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.tile(jnp.eye(4), (1, 2, 1, 1)),
                           jnp.zeros((1, 1, h, w, 3)), eye, eye,
                           method="init_all"))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    shapes)
    with _f64_attention():
        state = JGT.create_grasp_train_state(
            model, params, learning_rate=cfg.grasp_training.learning_rate)
        state, ok = JG.load_backbone(state, cfg)
        assert ok
        best = jckpt.load(os.path.join(model_path, "best"), state.params,
                          jckpt.GRASP_COMPONENTS)
        assert best is not None
        state = state.replace(params=jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), best))
        opt = JG.build_pose_optimizer(model, state, cfg)
        draw = opt.generate_initial_guesses
        # the ascent carries the poses: f64 guesses, as the energies are
        opt.generate_initial_guesses = lambda *a: [
            g.astype(np.float64) for g in draw(*a)]
        oc = dict(cfg.validation.grasp_opt_config.optimization_config)
        if not name.startswith("goal") and not alternate:
            oc["sync"] = True
        results = jsession.validate(
            opt, oc, JG.collect_valid_data(valid, cfg, model, state),
            JG.build_oracle(cfg), np.random.default_rng(0))
        return results, jsession.log_results("strong", results, False)


@pytest.mark.parametrize("name", FAMILIES)
def test_strong_validate_matches_jax(runs, name):
    """`strong_validate` on a run's `best` and backbone files against the
    JAX strong validation of the same files (8 guesses, 2 steps, rng 0),
    both in f64: each sample's five scored poses' errors 1e-4 absolute,
    their energies 1e-3 relative, `log_results`' dict 0.1 mm / 1e-4 rad;
    `strong_validate` returns `log_results` of `strong_results`."""
    overrides, model_path, backbone, _ = runs[name]
    got = convergence.strong_results(name, model_path, backbone, overrides,
                                     device="cpu", dtype=torch.float64,
                                     **STRONG)
    want, want_logged = _jax_strong(name, overrides, model_path, backbone)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a["errors_r"]),
                                   np.asarray(b["errors_r"]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(a["final_success"], b["final_success"],
                                   rtol=1e-3)
    logged = session.log_results("strong", got, False)
    for key in ("mean_r_error_t", "best_r_error_mean_t"):
        np.testing.assert_allclose(logged[key], want_logged[key], atol=0.1)
    for key in ("mean_r_error_r", "best_r_error_mean_r"):
        np.testing.assert_allclose(logged[key], want_logged[key],
                                   atol=np.degrees(1e-4))
    f64 = convergence.strong_validate(name, model_path, backbone, overrides,
                                      device="cpu", dtype=torch.float64,
                                      **STRONG)
    assert f64 == logged


def test_strong_validate_alternate_matches_the_jax_tool(runs):
    """`strong_results` under scripts/strong_alternate.py (`in_turn`) on
    the delta-NGF run's files against the JAX tool's own ascent (t and r
    phases in turn: the script sets no `sync`), both in f64: the scored
    poses' errors 1e-4 absolute and their energies 1e-3 relative, as
    above; the port's own, synchronized ascent scores them otherwise."""
    name = "dngf_convergence_cpu"
    overrides, model_path, backbone, _ = runs[name]
    with _script("strong_alternate").in_turn() as tool:
        got = tool.strong_results(name, model_path, backbone, overrides,
                                  device="cpu", dtype=torch.float64,
                                  **STRONG)
    assert convergence.strong_sync(name)
    want, _ = _jax_strong(name, overrides, model_path, backbone,
                          alternate=True)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a["errors_r"]),
                                   np.asarray(b["errors_r"]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(a["final_success"], b["final_success"],
                                   rtol=1e-3)
    synced = convergence.strong_results(name, model_path, backbone,
                                        overrides, device="cpu",
                                        dtype=torch.float64, **STRONG)
    assert any(not np.allclose(a["final_success"], b["final_success"])
               for a, b in zip(got, synced))


def test_controlled_strong_takes_trained_and_untrained(runs):
    """The controlled pair: `best` and the untrained readout seeded from
    `seed` on the same backbone, the same samples and rng; the trained
    entry is `strong_validate` of `best`, the untrained one differs."""
    overrides, model_path, backbone, _ = runs["goal_convergence_cpu"]
    pair = convergence.controlled_strong("goal_convergence_cpu", model_path,
                                         backbone, overrides, "cpu",
                                         **STRONG)
    assert pair["trained"] == convergence.strong_validate(
        "goal_convergence_cpu", model_path, backbone, overrides, "cpu",
        **STRONG)
    assert pair["untrained"] != pair["trained"]
    assert all(np.isfinite(v) for r in pair.values() for v in r.values()
               if not isinstance(v, str))


@pytest.mark.parametrize("name", FAMILIES)
def test_reader_gives_log_results_of_every_round(runs, name):
    """`read_grasp_rounds` of a run's `valid/results-<epoch>.pkl`: one
    entry per validation round, in epoch order, each `log_results`' four
    numbers as the session logged them (1e-12 relative)."""
    _, model_path, _, run = runs[name]
    logged = {e: d for e, d, _ in run.history["valid"] if e is not None}
    rounds = convergence.read_grasp_rounds(model_path)
    assert list(rounds) == sorted(logged) == [1, 2]
    for epoch, row in rounds.items():
        assert set(row) == set(logged[epoch]) - {"epoch"}
        for key, value in row.items():
            np.testing.assert_allclose(value, logged[epoch][key],
                                       rtol=1e-12)
    text = convergence.format_grasp_rounds(rounds)
    assert text.splitlines()[0].startswith("epoch  mean mm")
    assert len(text.splitlines()) == 3


def test_reader_and_strong_validate_import_no_jax(runs):
    """In a process where `tcnerf`, `jax` and `flax` cannot be imported,
    the reader unpickles the port's round files and `strong_validate`
    runs on the goal run's files; neither loads them."""
    overrides, model_path, backbone, _ = runs["goal_convergence_cpu"]
    code = f"""
import sys
for name in ("tcnerf", "jax", "flax"):
    sys.modules[name] = None
from tcnerf_torch.tools import convergence
rounds = convergence.read_grasp_rounds({str(model_path)!r})
assert list(rounds) == [1, 2], rounds
out = convergence.strong_validate("goal_convergence_cpu", {str(model_path)!r},
                                  {str(backbone)!r}, {overrides!r}, "cpu",
                                  n_guesses=4, n_steps=1)
assert set(out) >= {{"mean_r_error_t", "best_r_error_mean_t"}}, out
loaded = [m for m in sys.modules if m.split(".")[0] in ("tcnerf", "jax", "flax")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().endswith("ok")


TINY_CLIP = ["nerf_model.n_features=256", "nerf_model.clip_layers=[1,1,1,1]",
             "nerf_model.clip_width=8", "nerf_model.clip_embed_dim=32",
             "nerf_model.clip_text_width=16", "nerf_model.clip_text_layers=1",
             "nerf_model.clip_image_size=32", "grasp_training.n_epochs=1",
             "validation.valid_sample_indices=[0]"]


def test_reader_and_strong_validate_take_a_language_run(tmp_path):
    """A `language_convergence_cpu` run (v4 fusion co-trained, 6d poses,
    the instruction's tokens) on a backbone stored without a fusion
    decoder: the reader gives its round as logged, and `strong_validate`
    loads its `best` with the decoder and returns finite errors; the
    untrained readout's differ."""
    name = "language_convergence_cpu"
    overrides = ["device=cpu", f"data_dir={tmp_path}", *TINY, *TINY_CLIP]
    cfg = config.load_config(overrides, name)
    source = grasp_common.build_grasp_model(cfg, device="cpu")
    init_params(source, torch.Generator().manual_seed(5))
    ckpt.store(os.path.join(cfg.grasp_training.backbone_path, "model_final"),
               source, ckpt.BACKBONE_COMPONENTS)
    run = train_language.run_language_training(cfg)
    model_path = cfg.grasp_training.model_path
    assert os.path.exists(ckpt.component_path(
        os.path.join(model_path, "best"), "combine_clip_visual"))
    rounds = convergence.read_grasp_rounds(model_path)
    logged = {e: d for e, d, _ in run.history["valid"] if e is not None}
    assert list(rounds) == list(logged) == [1]
    for key, value in rounds[1].items():
        np.testing.assert_allclose(value, logged[1][key], rtol=1e-12)
    pair = convergence.controlled_strong(
        name, model_path, cfg.grasp_training.backbone_path, overrides, "cpu",
        n_guesses=4, n_steps=1)
    assert all(np.isfinite(v) for r in pair.values() for k, v in r.items()
               if k != "epoch")
    assert pair["trained"] != pair["untrained"]


# ------------------------------------------------------------------ CLI

class _FakeState:
    model = torch.nn.Linear(1, 1)


def _fake_history():
    return {"steps": [dict(step_s=0.01, data_s=0.001)] * 2,
            "valid": [(None, None, 0.1)]}


TRAINER_FUNCS = [(train_nerf, "_main"), (train_goal, "run_goal_training"),
                 (train_delta_ngf, "run_delta_training"),
                 (train_trajectory, "run_trajectory_training"),
                 (train_language, "run_language_training")]


@pytest.mark.parametrize("name,module", [
    ("nerf_convergence_cpu", train_nerf),
    ("goal_convergence_cpu", train_goal),
    ("dngf_convergence_cpu", train_delta_ngf),
    ("language_convergence_cpu", train_language)],
    ids=["nerf", "goal", "dngf", "language"])
def test_fit_dispatches_to_the_family_trainer(tmp_path, monkeypatch, capsys,
                                              name, module):
    """`--fit <config>` runs the trainer of the config's family, once, on
    the composed config with the overrides, and no other; a grasp fit then
    reads its rounds and runs the controlled strong validation of its
    `model_path` on its `backbone_path`."""
    called, strong = [], []

    def recorder(mod, fn):
        def run(cfg, *a, **kw):
            called.append((mod, cfg))
            if mod is train_nerf:
                path = cfg.nerf_training.model_path
                os.makedirs(path, exist_ok=True)
                with open(os.path.join(path, "metrics.jsonl"), "w") as f:
                    f.write('{"epoch": 0, "psnr_db": 10.0}\n')
                return _FakeState(), _fake_history()
            return grasp_common.GraspRun(_FakeState(), _fake_history(),
                                         None, None)
        return run

    for mod, fn in TRAINER_FUNCS:
        monkeypatch.setattr(mod, fn, recorder(mod, fn))
    monkeypatch.setattr(convergence, "controlled_strong",
                        lambda *a, **kw: strong.append(a) or {
                            "trained": dict(_ERRS, best_r_error_mean_t=40.0),
                            "untrained": _ERRS})
    overrides = ["device=cpu", f"data_dir={tmp_path}"]
    assert convergence.main(["--fit", name, *overrides]) == 0
    assert [m for m, _ in called] == [module]
    assert called[0][1] == config.load_config(overrides, name)
    out = capsys.readouterr().out
    assert f"fit {name}" in out
    if module is train_nerf:
        assert not strong and "run - record" in out
    else:
        cfg = called[0][1]
        assert strong == [(name, cfg.grasp_training.model_path,
                           cfg.grasp_training.backbone_path, overrides,
                           None, 1024, 32)]
        assert "epoch  mean mm" in out and "strong ascent" in out


_ERRS = {"epoch": "strong", "mean_r_error_t": 200.0, "mean_r_error_r": 100.0,
         "best_r_error_mean_t": 100.0, "best_r_error_mean_r": 90.0}


_GOAL = ("goal_convergence_cpu", "44.50 mm")
_LANGUAGE = ("language_convergence", "no strong-ascent record")


@pytest.mark.parametrize("trained_mm,flags,rc,record", [
    (40.0, ["--bar"], 0, _GOAL), (50.0, ["--bar"], 0, _GOAL),
    (60.0, ["--bar"], 1, _GOAL), (60.0, [], 0, _GOAL),
    (60.0, ["--bar", "--ratio", "0.7"], 0, _GOAL),
    (99.0, ["--bar"], 0, _LANGUAGE), (100.0, ["--bar"], 1, _LANGUAGE),
    (101.0, ["--bar"], 1, _LANGUAGE),
    (60.0, ["--bar", "--ratio", "0.5"], 1, _LANGUAGE)],
    ids=["below", "at", "above", "no-bar", "ratio", "language-below",
         "language-at", "language-above", "language-ratio"])
def test_strong_bar_exit_code(monkeypatch, capsys, trained_mm, flags, rc,
                              record):
    """`--strong <run> --backbone <path> --bar` exits 1 only when the
    trained best translational error is above `--ratio` times the
    untrained one (100 mm here): 0.5 unless given, or the record's own
    ratio; `language_convergence`'s is strict, trained below untrained,
    so a tie fails; both rows and the JAX record are printed."""
    config, printed = record
    seen = []
    monkeypatch.setattr(convergence, "controlled_strong",
                        lambda *a, **kw: seen.append(a) or {
                            "trained": dict(_ERRS,
                                            best_r_error_mean_t=trained_mm),
                            "untrained": _ERRS})
    argv = ["--strong", "/run", "--backbone", "/bb", "--config",
            config, "device=cpu", "data_dir=/d", *flags]
    assert convergence.main(argv) == rc
    assert seen == [(config, "/run", "/bb",
                     ["device=cpu", "data_dir=/d"], None, 1024, 32)]
    out = capsys.readouterr().out
    assert "trained" in out and "untrained" in out and printed in out
    assert ("FAIL" in out) == (rc == 1)


def _rounds(path, mean_mm):
    """`<path>/valid/results-<epoch>.pkl` as the session pickles a round:
    four samples whose five scored poses all err by `mean_mm[epoch]`."""
    import pickle

    os.makedirs(os.path.join(path, "valid"), exist_ok=True)
    for epoch, mm in mean_mm.items():
        errors = np.tile([mm / 1000, 0.5], (5, 1))
        with open(os.path.join(path, "valid", f"results-{epoch}.pkl"),
                  "wb") as f:
            pickle.dump([{"errors_r": errors} for _ in range(4)], f)


@pytest.mark.parametrize("mean_mm,flags,rc", [
    ({8: 330.0, 16: 310.0, 24: 290.0, 32: 250.0}, ["--bar"], 0),
    ({8: 296.0, 16: 330.0, 24: 330.0}, ["--bar"], 0),
    ({8: 330.0, 16: 310.0, 24: 300.0, 32: 200.0}, ["--bar"], 1),
    ({32: 200.0}, ["--bar"], 1),
    ({8: 330.0, 16: 310.0, 24: 300.0}, [], 0)],
    ids=["language-rounds-pass", "language-rounds-at-epoch-8",
         "language-rounds-fail", "language-rounds-missing",
         "language-rounds-no-bar"])
def test_language_round_bar_exit_code(tmp_path, capsys, mean_mm, flags, rc):
    """A `language_convergence` run's rounds print beside the JAX record's
    (docs/convergence_language_tpu_r4_metrics.jsonl: 330.68 / 329.65 /
    269.36 mm at epochs 8 / 16 / 24, top-1 277.40 at 24); under `--bar`
    the tool exits 1 unless the run's lowest `mean_r_error_t` over epochs
    8 / 16 / 24 is at most 1.1 x 269.36 mm (epoch 32 is outside it)."""
    _rounds(tmp_path, mean_mm)
    argv = [str(tmp_path), "--config", "language_convergence", *flags]
    assert convergence.main(argv) == rc
    out = capsys.readouterr().out
    for text in ("record mean mm", "330.68", "329.65", "269.36", "277.40",
                 "no strong-ascent record"):
        assert text in out
    assert ("round bar" in out) == bool(flags)
    assert ("FAIL" in out) == (rc == 1)


def test_grasp_records_cite_the_convergence_doc():
    """Each grasp record's cited lines of docs/convergence.md hold its
    strong-ascent numbers; both name the stage-1 config with a record."""
    with open(os.path.join(REPO, "docs", "convergence.md")) as f:
        lines = f.read().splitlines()
    for name, rec in convergence.GRASP_RECORDS.items():
        lo, hi = (int(x) for x in rec["source"].rsplit(":", 1)[1].split("-"))
        text = " ".join(lines[lo - 1:hi])
        t, r = rec["strong"]
        if t is None:   # no strong-ascent record: its best round is cited
            assert f"{rec['best_round'][0]} mm" in text, name
            best = min(convergence.record_rounds(name).values(),
                       key=lambda row: row["mean_r_error_t"])
            assert round(best["mean_r_error_t"], 1) == rec["best_round"][0]
        else:
            assert f"{t} mm / {r}" in text, name
        assert rec["backbone"] in convergence.RECORDS
        assert convergence.family(name) in convergence.TRAINERS


def test_strong_record_printed_only_under_its_ascent(monkeypatch):
    """The JAX records' strong-ascent errors came from the JAX tool's
    ascent (t and r in turn), which the port's tool takes for a goal run
    but not for a delta-NGF run (synchronized, as its trainer validates):
    a goal score prints the record's 44.50 mm, a delta-NGF score prints
    its ascent in place of 47.50 mm, and under scripts/strong_alternate.py
    prints 47.50 mm; the record alone states its ascent."""
    strong = {"trained": _ERRS, "untrained": _ERRS}
    goal = convergence.format_strong("goal_convergence_cpu", strong, 8, 2)
    assert "t and r in turn" in goal and "(t and r in turn) 44.50 mm" in goal
    dngf = convergence.format_strong("dngf_convergence_cpu", strong, 8, 2)
    assert "t and r together" in dngf and "47.50" not in dngf
    assert "not printed (its ascent took t and r in turn)" in dngf
    assert "best round 29.40 mm" in dngf
    assert ("(t and r in turn) 47.50 mm / 43.40 deg" in
            convergence.format_grasp_record("dngf_convergence_cpu"))
    with _script("strong_alternate").in_turn() as tool:
        alternate = tool.format_strong("dngf_convergence_cpu", strong, 8, 2)
    assert "(t and r in turn) 47.50 mm" in alternate
    assert "together" not in alternate
    assert convergence.strong_sync("dngf_convergence_cpu")


def test_dngf_record_prints_the_jax_fits_under_each_ascent():
    """The delta-NGF record carries the JAX trainer's own fits at seeds
    0-5 (PERF.md section 5, J 0-5): a synchronized score prints their
    synchronized spread (19.93-34.85 mm, mean 28.11, median 28.72), a
    score in turn through scripts/strong_alternate.py the spread in turn
    (22.85-98.00 mm); no other record has such fits."""
    strong = {"trained": _ERRS, "untrained": _ERRS}
    sync = convergence.format_strong("dngf_convergence_cpu", strong, 8, 2)
    assert "19.93-34.85 mm, mean 28.11, median 28.72" in sync
    with _script("strong_alternate").in_turn() as tool:
        alternate = tool.format_strong("dngf_convergence_cpu", strong, 8, 2)
    assert "22.85-98.00 mm, mean 38.62, median 26.22" in alternate
    goal = convergence.format_strong("goal_convergence_cpu", strong, 8, 2)
    assert "JAX trainer's own fits" not in goal
