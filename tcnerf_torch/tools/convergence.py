"""A run's validation curve beside the JAX package's record of the same
config: stage-1 PSNR, and the grasp stage's oracle errors.

    python -m tcnerf_torch.tools.convergence <model_path> \\
        [--config nerf_convergence_hashgrid_cpu] [--bar-db 1.5] \\
        [--at 128,256]

reads `<model_path>/metrics.jsonl` (one line per validation, as
`train/train_nerf.py` writes it; a path to the file itself also works) and
prints it epoch by epoch beside the record: the JAX package's own
`metrics.jsonl` of a run of the config, kept in `docs/` (RECORDS; read as
a plain file). With `--bar-db` it exits 1 when the run's PSNR falls more
than that many dB below the record's, or is missing, at a held epoch: the
epochs `--at` names, by default every one after the first validation
that both hold (epoch 0 is the initial weights, which differ between the
packages). A resumed run logs its first epoch again; the last line of an
epoch counts. With a grasp config (`--config goal_convergence_cpu`) it
reads the run's `valid/results-<epoch>.pkl` instead (`read_grasp_rounds`)
and prints each round's mean and best-of-sample oracle errors beside the
JAX record in `docs/convergence.md` (GRASP_RECORDS).

    python -m tcnerf_torch.tools.convergence --fit <config> [key=value ...] \\
        [--bar-db 1.5] [--at 1024] [--bar] [--ratio 0.5]

first fits the config through its trainer (TRAINERS, by the config
name's prefix: `nerf_*` through `train_nerf`, `goal_*` through
`train_goal`, `dngf_*` through `train_delta_ngf`, ...; on the card,
`device=cpu` runs on the CPU), with the overrides, and prints the run's
wall seconds (dataset synthesis included), its steps' median ms and
median wait for the prefetched batch (`data_s`), then compares its
`model_path` as above. A grasp fit then runs the strong-ascent validation
(`strong_validate`: 1024 guesses, 32 steps, `np.random.default_rng(0)`,
as the JAX `tools/strong_goal_validation.py`) on the run's `best`
checkpoint and on the untrained readout seeded from `seed`, on the same
backbone, and prints both beside the record.

    python -m tcnerf_torch.tools.convergence --strong <model_path> \\
        --backbone <stage-1 model_path> --config <grasp config> \\
        [key=value ...] [--bar] [--ratio 0.5]

runs that strong validation alone, on an existing run. With `--bar` a
grasp fit or `--strong` exits 1 unless the trained `best_r_error_mean_t`
is at most `--ratio` times the untrained one (the JAX record is printed,
not held: the initial weights and arithmetic differ between the packages).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

REPO = Path(__file__).resolve().parents[2]

# config name -> the JAX package's record of a run of it
RECORDS = {
    "nerf_convergence_hashgrid_cpu":
        "docs/convergence_hashgrid_cpu_metrics.jsonl",
    "nerf_convergence": "docs/convergence_nerf_tpu_r4_metrics.jsonl",
    "nerf_convergence_cpu": "docs/convergence_nerf_cpu2_metrics.jsonl",
}

# grasp config -> the JAX package's record of a run of it, in mm and
# degrees (docs/ holds no per-round file for these runs): the chance floor
# of the untrained readout, the best validation round and the best
# checkpoint under strong ascent, all on the `backbone` config's fit
GRASP_RECORDS = {
    "goal_convergence_cpu": dict(
        source="docs/convergence.md:102-110", backbone="nerf_convergence_cpu",
        chance=(250.0, 105.0), best_round=(37.0, None), strong=(44.5, 39.0)),
    "dngf_convergence_cpu": dict(
        source="docs/convergence.md:133-139", backbone="nerf_convergence_cpu",
        chance=(None, None), best_round=(29.4, 47.8), strong=(47.5, 43.4)),
}

# config-name prefix -> (trainer module under tcnerf_torch.train, its run
# function); the stage-1 one returns (state, history), the grasp ones a
# GraspRun
TRAINERS = {
    "nerf": ("train_nerf", "_main"),
    "goal": ("train_goal", "run_goal_training"),
    "dngf": ("train_delta_ngf", "run_delta_training"),
    "trajectory": ("train_trajectory", "run_trajectory_training"),
    "language": ("train_language", "run_language_training"),
}

# the strong ascent of tools/strong_goal_validation.py
STRONG_GUESSES = 1024
STRONG_STEPS = 32


def read_metrics(path) -> Dict[int, dict]:
    """epoch -> the last line logged for it, from a metrics.jsonl or the
    run directory that holds one."""
    path = Path(path)
    if path.is_dir():
        path = path / "metrics.jsonl"
    rows: Dict[int, dict] = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                rows[int(row["epoch"])] = row
    return rows


def margin_bars(record: Dict[int, dict], bar_db: float,
                at: Sequence[int]) -> Dict[int, Optional[float]]:
    """epoch -> the record's PSNR less `bar_db`, at each epoch of `at`; an
    epoch the record lacks has no bar it could pass (None)."""
    return {e: (record[e]["psnr_db"] - bar_db if e in record else None)
            for e in at}


def compare(run: Dict[int, dict], record: Dict[int, dict],
            bars: Optional[Dict[int, Optional[float]]] = None) -> List[dict]:
    """One row per epoch either curve or `bars` holds, in order: the run's
    and the record's PSNR (None where absent), their difference, the bar
    (None where the epoch is not held) and whether the run reaches it."""
    bars = bars or {}
    rows = []
    for epoch in sorted(set(run) | set(record) | set(bars)):
        got = run.get(epoch, {}).get("psnr_db")
        want = record.get(epoch, {}).get("psnr_db")
        held = epoch in bars
        bar = bars.get(epoch)
        rows.append(dict(
            epoch=epoch, psnr_db=got, record_db=want,
            diff_db=(got - want if got is not None and want is not None
                     else None),
            held=held, bar_db=bar,
            ok=(got is not None and bar is not None and got >= bar)
            if held else None))
    return rows


def passes(rows: List[dict]) -> bool:
    """Some epoch is held and the run reaches every held bar."""
    held = [r for r in rows if r["held"]]
    return bool(held) and all(r["ok"] for r in held)


def _db(x) -> str:
    return "-" if x is None else f"{x:.3f}"


def format_rows(rows: List[dict]) -> str:
    out = ["epoch  run dB  record dB  run - record  bar"]
    for r in rows:
        line = (f"{r['epoch']:5d}  {_db(r['psnr_db']):>6}  "
                f"{_db(r['record_db']):>9}  {_db(r['diff_db']):>12}")
        if r["held"]:
            line += f"  {_db(r['bar_db'])} {'OK' if r['ok'] else 'FAIL'}"
        out.append(line)
    return "\n".join(out)


def record_path(config: str) -> Path:
    if config not in RECORDS:
        raise ValueError(f"no JAX record of {config!r}; one of "
                         f"{sorted(RECORDS)}")
    return REPO / RECORDS[config]


def family(config: str) -> str:
    """The key of TRAINERS that trains the config: its name's prefix."""
    kind = config.split("_", 1)[0]
    if kind not in TRAINERS:
        raise ValueError(f"no trainer for {config!r}: its name starts with "
                         f"none of {sorted(TRAINERS)}")
    return kind


# ------------------------------------------------------- the grasp curve

def round_errors(results) -> Dict[str, float]:
    """One validation's errors as `session.log_results` logs them: the
    mean over every scored pose and the mean of each sample's best (the
    last of its `errors_r`), translation in mm and rotation in degrees."""
    import numpy as np

    errors = [np.asarray(r["errors_r"]) for r in results]
    mean = np.mean(np.concatenate(errors, axis=0), axis=0)
    best = np.mean(np.stack([e[-1] for e in errors], axis=0), axis=0)
    return {"mean_r_error_t": float(mean[0] * 1000),
            "mean_r_error_r": float(mean[1] / np.pi * 180),
            "best_r_error_mean_t": float(best[0] * 1000),
            "best_r_error_mean_r": float(best[1] / np.pi * 180)}


def read_grasp_rounds(model_path) -> Dict[int, Dict[str, float]]:
    """epoch -> `round_errors` of `<model_path>/valid/results-<epoch>.pkl`,
    as the port's session pickles them (their poses are
    `tcnerf_torch.tasks.transform.Affine`), in epoch order."""
    import pickle
    import re

    rounds = {}
    for path in Path(model_path, "valid").glob("results-*.pkl"):
        match = re.fullmatch(r"results-(\d+)\.pkl", path.name)
        if match:
            with open(path, "rb") as f:
                rounds[int(match.group(1))] = round_errors(pickle.load(f))
    return dict(sorted(rounds.items()))


def _mm(x) -> str:
    return "-" if x is None else f"{x:.2f}"


def format_grasp_rounds(rounds: Dict[int, Dict[str, float]]) -> str:
    out = ["epoch  mean mm  mean deg  best mm  best deg"]
    for epoch, r in rounds.items():
        out.append(f"{epoch:5d}  {_mm(r['mean_r_error_t']):>7}  "
                   f"{_mm(r['mean_r_error_r']):>8}  "
                   f"{_mm(r['best_r_error_mean_t']):>7}  "
                   f"{_mm(r['best_r_error_mean_r']):>8}")
    return "\n".join(out)


def format_grasp_record(config: str) -> str:
    rec = GRASP_RECORDS.get(config)
    if rec is None:
        return f"no JAX record of {config!r}"
    pairs = [f"{name} {_mm(t)} mm / {_mm(r)} deg" for name, (t, r) in (
        ("chance floor", rec["chance"]), ("best round", rec["best_round"]),
        ("strong ascent of best", rec["strong"]))]
    return (f"JAX record ({rec['source']}, on the {rec['backbone']} "
            f"backbone): {'; '.join(pairs)}")


# ---------------------------------------------------- strong validation

def strong_results(config: str, model_path, backbone_path,
                   overrides: Sequence[str] = (), device=None,
                   n_guesses: int = STRONG_GUESSES,
                   n_steps: int = STRONG_STEPS,
                   checkpoint: Optional[str] = "best", dtype=None):
    """The per-sample results of `session.validate` on a grasp run with
    `n_guesses` initial guesses and `n_steps` ascent steps, in the port's
    terms of tools/strong_goal_validation.py: the config with the model
    and backbone paths and the two overrides, the model seeded from `seed`
    (`build_grasp_model`) with the backbone loaded, then
    `<model_path>/<checkpoint>` (None: the untrained readout), the
    validation's pose optimizer, the configured oracle, the validation
    samples (a language run's with their instruction's tokens) and
    `np.random.default_rng(0)`. The family's trainer decides the dataset,
    the fusion, the stored components and the ascent's `sync`. `dtype`
    casts the loaded model (f64 for parity checks). On the card unless
    `device` (or the config's `device`) says otherwise."""
    import numpy as np

    from ..data.loaders import (load_dataset, load_dataset_baseline,
                                load_dataset_language)
    from ..device import resolve_device
    from ..models import checkpoint as ckpt
    from ..train import config as C
    from ..train import grasp_common as G
    from ..train.session import validate

    kind = family(config)
    if kind == "nerf":
        raise ValueError(f"{config!r} is a stage-1 config")
    oc_key = "validation.grasp_opt_config"
    cfg = C.load_config(
        [*overrides, f"grasp_training.model_path={model_path}",
         f"grasp_training.backbone_path={backbone_path}",
         f"{oc_key}.optimizer_config.n_initial_guesses={n_guesses}",
         f"{oc_key}.optimization_config.n_optimization_steps={n_steps}"],
        config)
    dev = resolve_device(device or cfg.get("device"))
    fusion = tokenize_fn = sync = None
    extras = ()
    valid_path = os.path.join(cfg.dataset.path, "valid")
    if kind == "goal":
        G.prepare_datasets(cfg, "goal")
        dataset = load_dataset_baseline(
            path=cfg.dataset.path, n_perspectives=cfg.dataset.n_perspectives,
            dataset_type="valid")
    elif kind == "language":
        from ..clip.tokenizer import tokenize as tokenize_fn
        G.prepare_datasets(cfg, "language")
        dataset = load_dataset_language(cfg.dataset.n_perspectives,
                                        valid_path)
        fusion, sync = cfg.grasp_training.get("fusion", "v4"), False
        extras = ("combine_clip_visual",)
    else:
        G.prepare_datasets(cfg, "grad")
        dataset = load_dataset(
            cfg.dataset.path, cfg.dataset.n_perspectives,
            record_grasp_pose=True,
            record_order=cfg.dataset.get("record_order", False),
            dataset_type="valid")
        sync = kind == "dngf"
    model = G.build_grasp_model(cfg, fusion=fusion, device=dev)
    _, loaded = G.load_backbone(model, cfg, fusion=fusion is not None)
    if not loaded:
        raise FileNotFoundError(f"no backbone at {backbone_path}")
    if checkpoint is not None:
        path = os.path.join(model_path, checkpoint)
        if not ckpt.load(path, model, ckpt.GRASP_COMPONENTS + extras):
            raise FileNotFoundError(f"no grasp checkpoint at {path}")
    if dtype is not None:
        model.to(dtype)
    optimization = cfg.validation.grasp_opt_config.optimization_config
    oc = optimization.to_dict()
    if sync is not None:
        oc["sync"] = sync
    return validate(G.build_pose_optimizer(model, cfg), oc,
                    G.collect_valid_data(dataset, cfg, model, tokenize_fn),
                    G.build_oracle(cfg), np.random.default_rng(0))


def strong_validate(config: str, model_path, backbone_path,
                    overrides: Sequence[str] = (), device=None,
                    n_guesses: int = STRONG_GUESSES,
                    n_steps: int = STRONG_STEPS,
                    checkpoint: Optional[str] = "best", dtype=None
                    ) -> Dict[str, float]:
    """`session.log_results("strong", ...)` of `strong_results`: the mean
    and best-of-sample errors in mm and degrees."""
    from ..train.session import log_results

    return log_results("strong", strong_results(
        config, model_path, backbone_path, overrides, device, n_guesses,
        n_steps, checkpoint, dtype), False)


def controlled_strong(config: str, model_path, backbone_path,
                      overrides: Sequence[str] = (), device=None,
                      n_guesses: int = STRONG_GUESSES,
                      n_steps: int = STRONG_STEPS) -> Dict[str, dict]:
    """`strong_validate` of the run's `best` checkpoint and of the
    untrained readout (seeded from `seed`) on the same backbone, with the
    same rng, samples, guesses and steps: {"trained": ..., "untrained":
    ...}."""
    return {name: strong_validate(config, model_path, backbone_path,
                                  overrides, device, n_guesses, n_steps,
                                  checkpoint)
            for name, checkpoint in (("trained", "best"),
                                     ("untrained", None))}


def passes_ratio(strong: Dict[str, dict], ratio: float) -> bool:
    """The trained translational best-of-sample error is at most `ratio`
    times the untrained one's."""
    return (strong["trained"]["best_r_error_mean_t"]
            <= ratio * strong["untrained"]["best_r_error_mean_t"])


def format_strong(config: str, strong: Dict[str, dict], n_guesses: int,
                  n_steps: int) -> str:
    out = [f"strong ascent ({n_guesses} guesses, {n_steps} steps, "
           f"np.random.default_rng(0)):"]
    for name, r in strong.items():
        out.append(f"  {name:9s} mean {_mm(r['mean_r_error_t'])} mm / "
                   f"{_mm(r['mean_r_error_r'])} deg, best "
                   f"{_mm(r['best_r_error_mean_t'])} mm / "
                   f"{_mm(r['best_r_error_mean_r'])} deg")
    out.append("  " + format_grasp_record(config))
    return "\n".join(out)


def report_strong(config: str, model_path, backbone_path,
                  overrides: Sequence[str], bar: Optional[float],
                  n_guesses: int = STRONG_GUESSES,
                  n_steps: int = STRONG_STEPS) -> bool:
    """`controlled_strong`, printed beside the record; whether it holds
    the ratio `bar` (True without one)."""
    strong = controlled_strong(config, model_path, backbone_path, overrides,
                               None, n_guesses, n_steps)
    print(format_strong(config, strong, n_guesses, n_steps))
    if bar is None:
        return True
    ok = passes_ratio(strong, bar)
    print(f"bar: trained best {_mm(strong['trained']['best_r_error_mean_t'])}"
          f" mm <= {bar} x untrained "
          f"{_mm(strong['untrained']['best_r_error_mean_t'])} mm "
          f"{'OK' if ok else 'FAIL'}")
    return ok


# ------------------------------------------------------------------ fits

def fit(config: str, overrides: Sequence[str] = ()):
    """The config's trainer (TRAINERS) on the config with the overrides;
    prints the run's wall seconds and step times. Returns (cfg, state,
    history)."""
    import importlib
    import statistics
    import time

    from ..train import config as C
    from .common import device_line

    kind = family(config)
    module, name = TRAINERS[kind]
    run = getattr(importlib.import_module(f"..train.{module}", __package__),
                  name)
    cfg = C.load_config(list(overrides), config)
    t0 = time.perf_counter()
    out = run(cfg)
    wall = time.perf_counter() - t0
    state, history = out if kind == "nerf" else (out.state, out.history)
    steps = history["steps"][1:] or history["steps"]
    print(f"fit {config} {' '.join(overrides)}: {len(history['steps'])} "
          f"steps and {len(history['valid'])} validations in {wall:.1f} s "
          f"(dataset synthesis included); step after the first: median "
          f"{1e3 * statistics.median(s['step_s'] for s in steps):.1f} ms, "
          f"waiting for the batch median "
          f"{1e3 * statistics.median(s['data_s'] for s in steps):.2f} ms"
          f" [{device_line(next(state.model.parameters()).device)}]")
    return cfg, state, history


def _grasp_report(config: str, model_path, backbone_path,
                  overrides: Sequence[str], bar: Optional[float],
                  strong: bool, **kw) -> bool:
    """A grasp run's curve beside the record, and with `strong` the
    controlled strong validation (`kw`: its guesses and steps); whether it
    holds `bar`."""
    print(f"run {os.fspath(model_path)} ({config})")
    print(format_grasp_rounds(read_grasp_rounds(model_path)))
    if not strong:
        print(format_grasp_record(config))
        return True
    return report_strong(config, model_path, backbone_path, overrides, bar,
                         **kw)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="a run's validation curve beside the JAX record")
    parser.add_argument("run", nargs="?",
                        help="model_path or its metrics.jsonl; with --fit, "
                             "the config to fit; with --strong, the first "
                             "override")
    parser.add_argument("overrides", nargs="*",
                        help="with --fit or --strong: the config's "
                             "key=value overrides")
    parser.add_argument("--fit", action="store_true")
    parser.add_argument("--strong", default=None, metavar="MODEL_PATH",
                        help="only the strong validation of this grasp run")
    parser.add_argument("--backbone", default=None,
                        help="with --strong: the stage-1 model_path")
    parser.add_argument("--config", default="nerf_convergence_hashgrid_cpu",
                        help=f"the run's config, one of {sorted(RECORDS)} "
                             f"or a grasp config; with --fit, the fitted "
                             f"one")
    parser.add_argument("--bar-db", type=float, default=None)
    parser.add_argument("--at", default=None,
                        help="comma-separated epochs to hold")
    parser.add_argument("--bar", action="store_true",
                        help="grasp: hold the trained best error at --ratio "
                             "of the untrained one")
    parser.add_argument("--ratio", type=float, default=0.5)
    parser.add_argument("--guesses", type=int, default=STRONG_GUESSES,
                        help="the strong ascent's initial guesses")
    parser.add_argument("--steps", type=int, default=STRONG_STEPS,
                        help="the strong ascent's steps")
    args = parser.parse_args(argv)
    strong = dict(n_guesses=args.guesses, n_steps=args.steps)
    bar = args.ratio if args.bar else None
    if args.fit or args.strong:
        logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                            format="%(asctime)s %(levelname)s %(message)s")
    if args.strong:
        if args.backbone is None:
            parser.error("--strong needs --backbone")
        overrides = ([args.run] if args.run else []) + args.overrides
        return 0 if report_strong(args.config, args.strong, args.backbone,
                                  overrides, bar, **strong) else 1
    if args.run is None:
        parser.error("a run (or with --fit, a config) is required")
    config = args.run if args.fit else args.config
    if family(config) != "nerf":
        if args.fit:
            cfg, _, _ = fit(config, args.overrides)
            model_path = cfg.grasp_training.model_path
            backbone_path = cfg.grasp_training.backbone_path
        else:
            model_path, backbone_path = args.run, None
        ok = _grasp_report(config, model_path, backbone_path, args.overrides,
                           bar, args.fit, **strong)
        return 0 if ok else 1
    run = args.run
    record = record_path(config)
    if args.fit:
        cfg, _, _ = fit(config, args.overrides)
        run = cfg.nerf_training.model_path
    runs, records = read_metrics(run), read_metrics(record)
    bars = None
    if args.bar_db is not None:
        at = ([int(e) for e in args.at.split(",")] if args.at is not None
              else [e for e in runs if e > 0 and e in records])
        bars = margin_bars(records, args.bar_db, at)
    rows = compare(runs, records, bars)
    print(f"run {os.fspath(run)} against {os.fspath(record)}")
    print(format_rows(rows))
    return 0 if bars is None or passes(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
