"""One fit round of a delta-NGF config from one start on several devices
and dtypes: how far the card's arithmetic parts from the CPU's over a
round.

    python scripts/round_parity.py --out DIR \\
        --runs cpu:float32:8,cuda:float32,cpu:float64:8,cuda:float64 \\
        [--config dngf_convergence_cpu] [--epochs 8] [key=value ...]

Each run trains the config for `--epochs` epochs as one fit round with its
validation, through `train_delta_ngf.run_delta_training`, from one readout:
the model seeded from `seed` on the CPU with the backbone loaded, stored as
`<out>/<run>/model_final` in an emptied run directory, which the trainer
resumes at epoch 0, so the
device's own seeded draw plays no part. A float64 run carries the model
and the batches in f64 (the trainer's f32 batches cast on their way to the
step); a CPU run's third field sets its torch threads (so two CPU runs
that differ only in their summation order measure rounding alone). Writes
`<out>/<run>.json` (per step the four metrics, the round's `log_results`,
per sample the five scored errors and energies, and the run's seconds)
and `<out>/<run>.npz` (the readout after the round; `start.npz` before
it); then prints, for each run after the first of its dtype, its largest
relative difference from that first: per metric at steps 1, 2, 4, ... and
the last, in the round's errors and energies, and in the readout (of each
tensor's largest entry, and of the largest change the first run's round
made)."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import shutil
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

METRICS = ("landscape_loss", "grad_loss_t", "grad_loss_r", "pred")


@contextlib.contextmanager
def float64():
    """The delta-NGF trainer with its model and batches in f64."""
    from tcnerf_torch.train import grasp_common, train_delta_ngf

    build, feed = train_delta_ngf.build_grasp_model, \
        grasp_common.prefetched_epochs

    def feed64(*a, **kw):
        for batch in feed(*a, **kw):
            yield [[x.double() if torch.is_floating_point(x) else x
                    for x in part] for part in batch]

    train_delta_ngf.build_grasp_model = lambda *a, **kw: build(
        *a, **kw).double()
    grasp_common.prefetched_epochs = feed64
    try:
        yield
    finally:
        train_delta_ngf.build_grasp_model = build
        grasp_common.prefetched_epochs = feed


def _readout(model) -> Dict[str, np.ndarray]:
    return {n: p.detach().double().cpu().numpy()
            for n, p in model.named_parameters()
            if n.startswith("grasp_readout.")}


def _start(cfg, path: str) -> None:
    """`<path>/model_final`: the model seeded from `seed` on the CPU with
    the backbone loaded (the trainer resumes it); its readout also goes to
    `<path>/../start.npz`."""
    from tcnerf_torch.models import checkpoint as ckpt
    from tcnerf_torch.train import grasp_common

    model = grasp_common.build_grasp_model(cfg, device="cpu")
    if not grasp_common.load_backbone(model, cfg)[1]:
        raise FileNotFoundError(
            f"no backbone at {cfg.grasp_training.backbone_path}")
    ckpt.store(os.path.join(path, "model_final"), model,
               ckpt.GRASP_COMPONENTS)
    np.savez(os.path.join(os.path.dirname(path), "start.npz"),
             **_readout(model))


def run_round(name: str, device: str, dtype: str, out: str, config: str,
              epochs: int, overrides: List[str]) -> Dict:
    """One round on `device` in `dtype`; writes and returns its record."""
    from tcnerf_torch.train import config as C
    from tcnerf_torch.train import train_delta_ngf

    path = os.path.join(out, name)
    shutil.rmtree(path, ignore_errors=True)
    cfg = C.load_config([*overrides, f"device={device}",
                         f"grasp_training.model_path={path}",
                         f"grasp_training.n_epochs={epochs}",
                         f"grasp_training.eval_after_epochs={epochs}"],
                        config)
    _start(cfg, path)
    t0 = time.perf_counter()
    with float64() if dtype == "float64" else contextlib.nullcontext():
        run = train_delta_ngf.run_delta_training(cfg)
    seconds = time.perf_counter() - t0
    with open(os.path.join(path, "valid", f"results-{epochs}.pkl"),
              "rb") as f:
        results = pickle.load(f)
    record = dict(
        name=name, device=device, dtype=dtype, seconds=seconds,
        steps=[{k: s[k] for k in METRICS} for s in run.history["steps"]],
        round={k: float(v) for k, v in run.history["valid"][-1][1].items()},
        errors=[np.asarray(r["errors_r"]).tolist() for r in results],
        energies=[list(map(float, r["final_success"])) for r in results])
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(record, f)
    np.savez(os.path.join(out, f"{name}.npz"), **_readout(run.state.model))
    return record


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def compare(ref: Dict, other: Dict, out: str) -> str:
    """`other` against `ref`: the lines that `main` prints."""
    n = min(len(ref["steps"]), len(other["steps"]))
    marks = sorted({1 << k for k in range(n.bit_length()) if 1 << k <= n}
                   | {n})
    lines = [f"{other['name']} against {ref['name']} ({n} steps; "
             f"{other['seconds']:.1f} s against {ref['seconds']:.1f} s)"]
    for k in METRICS:
        diffs = [f"{i}: " + format(_rel(other["steps"][i - 1][k],
                                        ref["steps"][i - 1][k]), ".1e")
                 for i in marks]
        lines.append(f"  {k:15s} " + "  ".join(diffs))
    top = "best_r_error_mean_t"
    round_rel = _rel(list(other["round"].values()),
                     list(ref["round"].values()))
    lines.append(f"  round: {round_rel:.1e} (top-1 {other['round'][top]:.2f}"
                 f" mm against {ref['round'][top]:.2f}); errors "
                 f"{_rel(other['errors'], ref['errors']):.1e}, energies "
                 f"{_rel(other['energies'], ref['energies']):.1e}")
    a, b, start = (np.load(os.path.join(out, f"{name}.npz"))
                   for name in (ref["name"], other["name"], "start"))
    moved = max(float(np.abs(a[k] - start[k]).max()) for k in a.files)
    apart = max(float(np.abs(b[k] - a[k]).max()) for k in a.files)
    lines.append(f"  readout: {max(_rel(b[k], a[k]) for k in a.files):.1e}"
                 f" of a tensor's largest entry; {apart / moved:.1e} of the "
                 f"round's largest change")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import logging

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("overrides", nargs="*")
    parser.add_argument("--out", required=True)
    parser.add_argument("--runs", default="cpu:float32,cuda:float32")
    parser.add_argument("--config", default="dngf_convergence_cpu")
    parser.add_argument("--epochs", type=int, default=8)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    records = []
    for spec in args.runs.split(","):
        device, dtype, *threads = spec.split(":")
        name = f"{device}_{dtype}"
        if threads:
            torch.set_num_threads(int(threads[0]))
            name += f"_t{threads[0]}"
        records.append(run_round(name, device, dtype, args.out, args.config,
                                 args.epochs, args.overrides))
        print(f"{name}: {len(records[-1]['steps'])} steps and the round in "
              f"{records[-1]['seconds']:.1f} s; top-1 "
              f"{records[-1]['round']['best_r_error_mean_t']:.2f} mm",
              flush=True)
    first: Dict[str, Dict] = {}
    for record in records:
        ref = first.setdefault(record["dtype"], record)
        if ref is not record:
            print(compare(ref, record, args.out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
