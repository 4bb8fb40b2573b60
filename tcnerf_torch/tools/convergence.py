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
and prints each round's oracle errors (the top-5 mean and the top-1, by
energy) beside the JAX record in `docs/convergence.md` (GRASP_RECORDS).

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

runs that strong validation alone, on an existing run. Its ascent is the
family's trainer's (`strong_sync`): a delta-NGF run's takes the t and r
phases together, every other family's in turn. The JAX tool takes them in
turn for every family (it sets no `sync`), so a delta-NGF score is printed
without the record's strong-ascent error, which that ascent produced.
With `--bar` a grasp fit or `--strong` exits 1 unless the trained
`best_r_error_mean_t` is at most `--ratio` times the untrained one (by
default 0.5, or the record's `ratio`: for `language_convergence` the
trained error must be below the untrained one; the JAX record's strong
error is printed, not held: the initial weights and arithmetic differ
between the packages). Where docs/ keeps the record's
rounds (`language_convergence`), they are printed beside the run's, and
`--bar` also exits 1 unless the run's lowest `mean_r_error_t` over the
record's epochs is at most `round_bar` (1.1) times the record's lowest.
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
# degrees: the chance floor of the untrained readout, the best validation
# round and the best checkpoint under strong ascent (None: not recorded),
# all on the `backbone` config's fit; `strong_sync`: whether that strong
# ascent took the t and r phases together (tools/strong_goal_validation.py
# sets no `sync`: in turn). Where docs/ keeps the run's rounds (`rounds`,
# one line per validation as `log_results` logs it), they are printed
# beside the run's, and `--bar` also holds `round_bar`: the run's lowest
# `mean_r_error_t` over the record's epochs is at most that many times the
# record's lowest; `ratio` is the record's default `--ratio`, and with
# `strict` the trained error must be below it, not at it. `jax_fits`:
# the strong top-1 (mm) of the JAX trainer's own fits at seeds 0-5 on the
# port's backbone, scored by the port's tool under each ascent, printed
# beside a score of that ascent.
GRASP_RECORDS = {
    "goal_convergence_cpu": dict(
        source="docs/convergence.md:102-110", backbone="nerf_convergence_cpu",
        chance=(250.0, 105.0), best_round=(37.0, None), strong=(44.5, 39.0),
        strong_sync=False),
    "dngf_convergence_cpu": dict(
        source="docs/convergence.md:133-139", backbone="nerf_convergence_cpu",
        chance=(None, None), best_round=(29.4, 47.8), strong=(47.5, 43.4),
        strong_sync=False,
        jax_fits=dict(source="PERF.md section 5, J 0-5",
                      together=(34.49, 19.93, 21.95, 23.17, 34.27, 34.85),
                      in_turn=(98.00, 26.87, 24.57, 25.57, 33.88, 22.85))),
    "language_convergence": dict(
        source="docs/convergence.md:180-197", backbone="nerf_convergence",
        chance=(330.0, None), best_round=(269.4, None), strong=(None, None),
        strong_sync=False,
        rounds="docs/convergence_language_tpu_r4_metrics.jsonl",
        round_bar=1.1, ratio=1.0, strict=True),
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
    mean over every scored pose (each sample's top 5 by energy) and the
    mean of each sample's top-1 pose by energy (the last of its
    `errors_r`), translation in mm and rotation in degrees."""
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


def record_rounds(config: str) -> Dict[int, Dict[str, float]]:
    """epoch -> the JAX record's round of a grasp config, from the file
    GRASP_RECORDS names (`rounds`); empty where docs/ keeps none."""
    path = GRASP_RECORDS.get(config, {}).get("rounds")
    return dict(sorted(read_metrics(REPO / path).items())) if path else {}


_ROUND_KEYS = ("mean_r_error_t", "mean_r_error_r", "best_r_error_mean_t",
               "best_r_error_mean_r")


def format_grasp_rounds(rounds: Dict[int, Dict[str, float]],
                        record: Optional[Dict[int, dict]] = None) -> str:
    """The run's rounds; with the record's rounds, those beside them (mean
    and top-1 translational errors) at every epoch either holds."""
    record = record or {}
    out = ["epoch  mean mm  mean deg  top-1 mm  top-1 deg"
           + ("  record mean mm  record top-1 mm" if record else "")]
    for epoch in sorted(set(rounds) | set(record)):
        r = rounds.get(epoch, dict.fromkeys(_ROUND_KEYS))
        line = (f"{epoch:5d}  {_mm(r['mean_r_error_t']):>7}  "
                f"{_mm(r['mean_r_error_r']):>8}  "
                f"{_mm(r['best_r_error_mean_t']):>8}  "
                f"{_mm(r['best_r_error_mean_r']):>9}")
        if record:
            rec = record.get(epoch, {})
            line += (f"  {_mm(rec.get('mean_r_error_t')):>14}  "
                     f"{_mm(rec.get('best_r_error_mean_t')):>15}")
        out.append(line)
    return "\n".join(out)


def passes_rounds(config: str, rounds: Dict[int, Dict[str, float]]
                  ) -> Optional[bool]:
    """The record's round bar (GRASP_RECORDS `round_bar`): the run's
    lowest `mean_r_error_t` over the record's epochs is at most
    `round_bar` times the record's lowest; None where the record holds no
    such bar. A run without those epochs fails."""
    bar = GRASP_RECORDS.get(config, {}).get("round_bar")
    if bar is None:
        return None
    record = record_rounds(config)
    got = [rounds[e]["mean_r_error_t"] for e in record if e in rounds]
    want = min(r["mean_r_error_t"] for r in record.values())
    ok = bool(got) and min(got) <= bar * want
    print(f"round bar: lowest mean {_mm(min(got) if got else None)} mm over "
          f"epochs {sorted(record)} <= {bar} x the record's {_mm(want)} mm "
          f"{'OK' if ok else 'FAIL'}")
    return ok


def _ascent(sync: bool) -> str:
    return "t and r together" if sync else "t and r in turn"


def format_grasp_record(config: str, with_strong: bool = True) -> str:
    """The record's errors; its strong-ascent error only `with_strong`
    (else the ascent that produced it is named in its place)."""
    rec = GRASP_RECORDS.get(config)
    if rec is None:
        return f"no JAX record of {config!r}"
    pairs = [f"{name} {_mm(t)} mm / {_mm(r)} deg" for name, (t, r) in (
        ("chance floor", rec["chance"]), ("best round", rec["best_round"]))]
    ascent = _ascent(rec["strong_sync"])
    t, r = rec["strong"]
    if t is None:
        pairs.append("no strong-ascent record")
    else:
        pairs.append(f"strong ascent of best ({ascent}) {_mm(t)} mm / "
                     f"{_mm(r)} deg" if with_strong else
                     f"strong ascent of best not printed (its ascent took "
                     f"{ascent})")
    return (f"JAX record ({rec['source']}, on the {rec['backbone']} "
            f"backbone): {'; '.join(pairs)}")


# ---------------------------------------------------- strong validation

def strong_sync(config: str) -> bool:
    """Whether the strong ascent of a grasp config's run takes the t and r
    phases together (`sync`), as its family's trainer validates: a
    delta-NGF run's does, every other family's takes them in turn."""
    return family(config) == "dngf"


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
    the fusion and the stored components; `strong_sync` the ascent's
    `sync`. `dtype` casts the loaded model (f64 for parity checks). On the
    card unless `device` (or the config's `device`) says otherwise."""
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
    fusion = tokenize_fn = None
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
        fusion = cfg.grasp_training.get("fusion", "v4")
        extras = ("combine_clip_visual",)
    else:
        G.prepare_datasets(cfg, "grad")
        dataset = load_dataset(
            cfg.dataset.path, cfg.dataset.n_perspectives,
            record_grasp_pose=True,
            record_order=cfg.dataset.get("record_order", False),
            dataset_type="valid")
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
    oc = {**optimization.to_dict(), "sync": strong_sync(config)}
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
    (top 5) and top-1 errors in mm and degrees."""
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
    same rng, samples, guesses, steps and ascent: {"trained": ...,
    "untrained": ...}."""
    return {name: strong_validate(config, model_path, backbone_path,
                                  overrides, device, n_guesses, n_steps,
                                  checkpoint)
            for name, checkpoint in (("trained", "best"),
                                     ("untrained", None))}


def passes_ratio(strong: Dict[str, dict], ratio: float,
                 strict: bool = False) -> bool:
    """The trained translational top-1 error (`best_r_error_mean_t`) is
    at most `ratio` times the untrained one's (below it, with `strict`)."""
    trained = strong["trained"]["best_r_error_mean_t"]
    bound = ratio * strong["untrained"]["best_r_error_mean_t"]
    return trained < bound if strict else trained <= bound


def format_strong(config: str, strong: Dict[str, dict], n_guesses: int,
                  n_steps: int) -> str:
    """`strong` beside the record, whose strong-ascent error is printed
    only if this tool's ascent for `config` is the one that produced it."""
    sync = strong_sync(config)
    out = [f"strong ascent ({n_guesses} guesses, {n_steps} steps, "
           f"{_ascent(sync)}, np.random.default_rng(0)):"]
    for name, r in strong.items():
        out.append(f"  {name:9s} mean {_mm(r['mean_r_error_t'])} mm / "
                   f"{_mm(r['mean_r_error_r'])} deg, top-1 "
                   f"{_mm(r['best_r_error_mean_t'])} mm / "
                   f"{_mm(r['best_r_error_mean_r'])} deg")
    rec = GRASP_RECORDS.get(config)
    out.append("  " + format_grasp_record(
        config, rec is None or rec["strong_sync"] == sync))
    fits = (rec or {}).get("jax_fits")
    if fits is not None:
        out.append("  " + format_jax_fits(fits, sync))
    return "\n".join(out)


def format_jax_fits(fits: dict, sync: bool) -> str:
    """The spread of the JAX trainer's own fits (GRASP_RECORDS
    `jax_fits`) under the ascent `sync` names: strong top-1 per seed."""
    import statistics

    mm = fits["together" if sync else "in_turn"]
    return (f"the JAX trainer's own fits at seeds 0-{len(mm) - 1} "
            f"({fits['source']}), strong top-1 under this ascent: "
            f"{_mm(min(mm))}-{_mm(max(mm))} mm, mean "
            f"{_mm(statistics.mean(mm))}, median "
            f"{_mm(statistics.median(mm))}")


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
    strict = GRASP_RECORDS.get(config, {}).get("strict", False)
    ok = passes_ratio(strong, bar, strict)
    print(f"bar: trained top-1 "
          f"{_mm(strong['trained']['best_r_error_mean_t'])}"
          f" mm {'<' if strict else '<='} {bar} x untrained "
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

    import torch

    from ..train import config as C
    from .common import device_line

    kind = family(config)
    module, name = TRAINERS[kind]
    run = getattr(importlib.import_module(f"..train.{module}", __package__),
                  name)
    cfg = C.load_config(list(overrides), config)
    kernels = _kernel_libs()
    before = [dict(lib.counts) for lib in kernels]
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run(cfg)
    wall = time.perf_counter() - t0
    state, history = out if kind == "nerf" else (out.state, out.history)
    steps = history["steps"][1:] or history["steps"]
    device = next(state.model.parameters()).device
    print(f"fit {config} {' '.join(overrides)}: {len(history['steps'])} "
          f"steps and {len(history['valid'])} validations in {wall:.1f} s "
          f"(dataset synthesis included); step after the first: median "
          f"{1e3 * statistics.median(s['step_s'] for s in steps):.1f} ms, "
          f"waiting for the batch median "
          f"{1e3 * statistics.median(s['data_s'] for s in steps):.2f} ms"
          f" [{device_line(device)}]")
    if device.type == "cuda":
        counts = {k: v - was.get(k, 0) for lib, was in zip(kernels, before)
                  for k, v in lib.counts.items() if v > was.get(k, 0)}
        print(f"fit peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB (max_memory_allocated); chain-kernel launches {counts} "
              f"over {len(history['steps'])} steps and "
              f"{len(history['valid'])} validations")
    return cfg, state, history


def _kernel_libs():
    """The port's kernel libraries, whose `counts` its wrappers raise."""
    from ..ops.gather import GATHER
    from ..ops.resmlp import RESMLP
    from ..ops.swg import SWG
    return RESMLP, SWG, GATHER


def _grasp_report(config: str, model_path, backbone_path,
                  overrides: Sequence[str], bar: Optional[float],
                  strong: bool, **kw) -> bool:
    """A grasp run's curve beside the record (its rounds too, where docs/
    keeps them), and with `strong` the controlled strong validation (`kw`:
    its guesses and steps); whether it holds `bar` and, under a `bar`, the
    record's round bar (`passes_rounds`)."""
    print(f"run {os.fspath(model_path)} ({config})")
    rounds = read_grasp_rounds(model_path)
    print(format_grasp_rounds(rounds, record_rounds(config)))
    ok = bar is None or passes_rounds(config, rounds) is not False
    if not strong:
        print(format_grasp_record(config))
        return ok
    return report_strong(config, model_path, backbone_path, overrides, bar,
                         **kw) and ok


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
    parser.add_argument("--ratio", type=float, default=None,
                        help="default: the record's `ratio`, else 0.5")
    parser.add_argument("--guesses", type=int, default=STRONG_GUESSES,
                        help="the strong ascent's initial guesses")
    parser.add_argument("--steps", type=int, default=STRONG_STEPS,
                        help="the strong ascent's steps")
    args = parser.parse_args(argv)
    strong = dict(n_guesses=args.guesses, n_steps=args.steps)
    config = args.run if args.fit else args.config
    ratio = (args.ratio if args.ratio is not None else
             GRASP_RECORDS.get(config, {}).get("ratio", 0.5))
    bar = ratio if args.bar else None
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
