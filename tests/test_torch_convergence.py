"""tcnerf_torch's convergence runs against the JAX package on the CPU: a
hash-grid fit of 12 optimizer steps in f64 step by step against optax,
the 7 convergence configs through their entry points, a tiny run of each
CPU-sized one, the `TCNERF_TRACE` trace of the first fit round, and
`tools/convergence.py`'s comparison with the JAX records in `docs/`.

The hash-grid renderer is tests/test_torch_hashgrid.py's (16 levels of
2^10 rows, 16-wide 2-layer MLPs, 8 + 8 samples, 24x32 sources); the
entry-point runs use the grasp tests' tiny widths (48x64, ViT 32 at 32^2,
2 blocks of 32). Bar: f64 1e-9 relative.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_fusion import _draw
from test_torch_grasp_train import _close64
from test_torch_hashgrid import (H, W, S, _port_renderer, _render_scene,
                                 _render_tree)
from tcnerf.models import training as jtrain
from tcnerf.train import config as jconfig
from tcnerf_torch.core.rays import get_specific_rays
from tcnerf_torch.data.synthetic import camera_ring
from tcnerf_torch.models import training
from tcnerf_torch.params import from_flax
from tcnerf_torch.tools import convergence
from tcnerf_torch.train import (config, train_delta_ngf, train_goal,
                                train_language, train_nerf)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.join(REPO, "tcnerf", "configs")


# ------------------------------------------------------- the trajectory

def test_hashgrid_fit_trajectory_matches_optax():
    """12 optimizer steps of the hash-grid renderer from one flax tree, in
    f64, on 12 batches of 128 rays with the JAX draws of each step: the
    loss before each update and every parameter after it within 1e-9 x
    its tensor's max |jax|. warmup_steps 4 and scale_down_after 8 put
    both edges of the schedule inside the run (rates 0, 1/4 ... 1, then
    the constant, then 0.1 x); optax evaluates the schedule before the
    update, the port's NerfOptimizer too."""
    fm, tree = _render_tree()
    rng = np.random.default_rng(12)
    scene = _render_scene()
    ring = camera_ring(2, height=H, width=W, azimuth_span=0.6)
    rays = 128
    batches = []
    for _ in range(12):
        ro, rd = get_specific_rays(rng.uniform(0, W - 1, rays),
                                   rng.uniform(0, H - 1, rays),
                                   ring[1]["pose"],
                                   ring[1]["intrinsics"].reshape(3, 3))
        batches.append(((ro[None], rd[None]) + scene[2:],
                        rng.uniform(size=(1, rays, 3))))
    knobs = dict(nerf_lr=1e-2, feature_lr=1e-2, warmup_steps=4,
                 scale_down_after=8)
    m = _port_renderer(tree, torch.float64)
    state = training.create_train_state(
        m, training.make_nerf_optimizer(m, **knobs))
    with jax.enable_x64(True):
        tx = jtrain.make_nerf_optimizer(**knobs)
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree)
        opt_state = tx.init(params)

        @jax.jit
        def step(p, o, inputs, labels, key):
            def loss_fn(q):
                rgb, _, fine_rgb, _, aux = fm.apply(
                    {"params": q}, inputs, rngs={"sampling": key})
                return (jtrain.mse(labels, rgb)
                        + jtrain.mse(labels, fine_rgb) + aux)

            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, o = tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, loss

        for i, (inputs, labels) in enumerate(batches):
            key = jax.random.PRNGKey(100 + i)
            j_in = tuple(jnp.asarray(x, jnp.float64) for x in inputs)
            draws = fm.apply({"params": params}, 1, rays, S, method=_draw,
                             rngs={"sampling": key})
            params, opt_state, loss64 = step(params, opt_state, j_in,
                                             jnp.asarray(labels), key)
            t_in = tuple(torch.as_tensor(np.asarray(x, np.float64))
                         for x in inputs)
            state.optimizer.zero_grad()
            loss = training.nerf_loss(
                m, t_in, torch.as_tensor(labels),
                *(torch.as_tensor(np.array(u)) for u in draws))
            loss.backward()
            state.apply_gradients()
            _close64(float(loss.detach()), float(loss64), 1e-9,
                     f"loss, step {i}")
            want = from_flax(jax.device_get(params), np.float64)
            for name, p in m.named_parameters():
                _close64(p.detach().numpy(), want[name].numpy(), 1e-9,
                         f"{name} after step {i}")
    assert state.step == state.optimizer.count == 12


# ------------------------------------------------ configs, entry points

NEW_CONFIGS = [("nerf_convergence", train_nerf, "_main"),
               ("nerf_convergence_cpu", train_nerf, "_main"),
               ("goal_convergence", train_goal, "run_goal_training"),
               ("goal_convergence_cpu", train_goal, "run_goal_training"),
               ("language_convergence", train_language,
                "run_language_training"),
               ("language_convergence_cpu", train_language,
                "run_language_training"),
               ("dngf_convergence_cpu", train_delta_ngf,
                "run_delta_training")]


@pytest.mark.parametrize("name,module,run", NEW_CONFIGS,
                         ids=[n for n, _, _ in NEW_CONFIGS])
def test_entry_point_takes_the_convergence_config(monkeypatch, name,
                                                  module, run):
    """`--config-name=<name>` on the trainer the JAX configs name composes
    the JAX package's YAML config."""
    seen = []
    monkeypatch.setattr(module, run, lambda cfg, **kw: seen.append(cfg))
    module.main([f"--config-name={name}", "data_dir=/tmp/x"])
    assert seen == [jconfig.load_config(ROOT, name,
                                        ["data_dir=/tmp/x"]).to_dict()]


TINY_NERF = ["nerf_model.original_image_size=[48,64]", "nerf_model.n_samples=4",
             "nerf_model.n_rays_train=16", "nerf_model.vit_size=[32,32]",
             "nerf_model.vit_dim=32", "nerf_model.vit_heads=2",
             "nerf_model.vit_hooks=[1,2,3,4]", "nerf_model.n_blocks=2",
             "nerf_model.hidden_size=32"]
TINY_GRASP = TINY_NERF + [
    "nerf_model.n_features=32", "grasp_model.n_5d_poses=3",
    "grasp_training.n_epochs=1", "grasp_training.eval_after_epochs=1",
    "dataset.n_synthetic_samples=2", "validation.valid_sample_indices=[0]",
    "validation.grasp_opt_config.optimizer_config.n_initial_guesses=8",
    "validation.grasp_opt_config.optimization_config.n_optimization_steps=2",
    "generator_grasp.n_points_train=16", "generator_grasp.n_r_fraction=4",
    "generator_grasp.pose_augmentation_factor=4",
    "generator_grasp.n_future_poses=4"]
TINY_CLIP = ["nerf_model.n_features=256", "nerf_model.clip_layers=[1,1,1,1]",
             "nerf_model.clip_width=8", "nerf_model.clip_embed_dim=32",
             "nerf_model.clip_text_width=16", "nerf_model.clip_text_layers=1",
             "nerf_model.clip_image_size=32"]


@pytest.mark.parametrize("name,module,extra", [
    ("nerf_convergence_cpu", train_nerf,
     ["nerf_training.n_epochs=1", "nerf_training.eval_after_epochs=1",
      "dataset.n_synthetic_samples=2"]),
    ("goal_convergence_cpu", train_goal, []),
    ("dngf_convergence_cpu", train_delta_ngf, []),
    ("language_convergence_cpu", train_language, TINY_CLIP)],
    ids=["nerf", "goal", "dngf", "language"])
def test_cpu_convergence_config_runs_one_epoch(tmp_path, name, module,
                                               extra):
    """One epoch of each CPU-sized convergence config through its entry
    point on the CPU at a tiny width: finite losses, and the stage-1 run's
    `metrics.jsonl` (epochs 0 and 1, read by tools/convergence.py) or the
    grasp run's validation pickle."""
    tiny = TINY_NERF if module is train_nerf else TINY_GRASP
    over = ["device=cpu", f"data_dir={tmp_path}", *tiny, *extra]
    out = module.main([f"--config-name={name}", *over])
    cfg = config.load_config(over, name)
    if module is train_nerf:
        _, history = out
        assert all(np.isfinite(s["loss"]) for s in history["steps"])
        rows = convergence.read_metrics(cfg.nerf_training.model_path)
        assert sorted(rows) == [0, 1]
        assert all(np.isfinite(r["psnr_db"]) for r in rows.values())
    else:
        assert all(np.isfinite(v) for s in out.history["steps"]
                   for k, v in s.items() if k.startswith("loss"))
        valid = os.listdir(os.path.join(cfg.grasp_training.model_path,
                                        "valid"))
        assert "results-1.pkl" in valid


HASHGRID_TINY = ["device=cpu", "nerf_model.original_image_size=[24,32]",
                 "nerf_model.n_samples=4", "nerf_model.n_rays_train=64",
                 "nerf_model.hashgrid_table_log2=8",
                 "nerf_training.n_epochs=4",
                 "nerf_training.eval_after_epochs=2",
                 "dataset.n_perspectives=6", "valid_perspective_tgt_idx=4",
                 "valid_perspective_src_indices=[1]"]


def test_trace_env_traces_the_first_fit_round(tmp_path, monkeypatch):
    """TCNERF_TRACE=<dir>: the first fit round's steps are profiled into
    one Chrome trace file in <dir> (two rounds run, one file), as the JAX
    trainer traces its first round."""
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("TCNERF_TRACE", str(trace_dir))
    _, history = train_nerf.main([
        "--config-name=nerf_convergence_hashgrid_cpu",
        f"data_dir={tmp_path}", *HASHGRID_TINY])
    assert len(history["steps"]) == 4
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("backward" in n.lower() for n in names)


# ----------------------------------------------------------- the tool

def _metrics(path, rows):
    with open(path, "w") as f:
        for epoch, value in rows:
            f.write(json.dumps({"epoch": epoch, "loss": None,
                                "psnr_db": value, "t": 0.0}) + "\n")


def test_records_name_the_jax_runs_of_their_configs():
    """Each record is a JAX run's metrics.jsonl in docs/ whose epochs step
    by its config's eval_after_epochs."""
    for name, rel in convergence.RECORDS.items():
        rows = convergence.read_metrics(os.path.join(REPO, rel))
        step = jconfig.load_config(ROOT, name).nerf_training.eval_after_epochs
        assert min(rows) == 0 and all(e % step == 0 for e in rows), name
    hg = convergence.read_metrics(
        convergence.record_path("nerf_convergence_hashgrid_cpu"))
    assert round(hg[128]["psnr_db"], 2) == 22.52
    assert round(hg[1024]["psnr_db"], 2) == 27.84


@pytest.mark.parametrize("rows,at,rc", [
    ([(0, 5.0), (64, 18.3), (128, 21.1)], "128", 0),
    ([(0, 5.0), (64, 18.3), (128, 21.0)], "128", 1),
    ([(0, 5.0), (64, 18.0), (128, 22.0)], None, 1),
    ([(0, 5.0), (64, 18.3)], "64,128", 1)],
    ids=["above", "below", "default-epochs", "missing"])
def test_tool_holds_the_bar(tmp_path, capsys, rows, at, rc):
    """--bar-db 1.5 against the hash-grid record (19.75 dB at 64, 22.52 at
    128): the run passes where it is at most 1.5 dB below at every held
    epoch (`--at`, by default all after 0) and fails where it is below,
    or where an epoch to hold is missing."""
    path = tmp_path / "metrics.jsonl"
    _metrics(path, rows)
    argv = [str(tmp_path), "--bar-db", "1.5"] + (["--at", at] if at else [])
    assert convergence.main(argv) == rc
    assert "run - record" in capsys.readouterr().out


def test_tool_takes_the_last_line_of_a_resumed_epoch(tmp_path):
    """A resumed run logs its first validation epoch again: the last line
    counts."""
    path = tmp_path / "metrics.jsonl"
    _metrics(path, [(0, 11.0), (64, 10.0), (64, 19.0)])
    record = convergence.read_metrics(convergence.record_path(
        "nerf_convergence_hashgrid_cpu"))
    rows = convergence.compare(convergence.read_metrics(path), record,
                               convergence.margin_bars(record, 1.5, [64]))
    by_epoch = {r["epoch"]: r for r in rows}
    assert by_epoch[64]["psnr_db"] == 19.0 and by_epoch[64]["ok"]
    assert not by_epoch[0]["held"] and not by_epoch[128]["held"]
