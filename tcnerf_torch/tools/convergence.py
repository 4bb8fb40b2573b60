"""A stage-1 run's validation curve beside the JAX package's record of the
same config.

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
epoch counts.

    python -m tcnerf_torch.tools.convergence --fit <config> [key=value ...] \\
        [--bar-db 1.5] [--at 1024]

first fits the config through `train_nerf` (on the card; `device=cpu`
runs on the CPU), with the overrides, and prints the run's wall seconds
(dataset synthesis included), its steps' median ms and median wait for
the prefetched batch (`data_s`), then compares its `model_path` as above.
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


def fit(config: str, overrides: Sequence[str] = ()):
    """`train_nerf._main` on the config with the overrides; prints the
    run's wall seconds and step times. Returns (cfg, state, history)."""
    import statistics
    import time

    from ..train import config as C
    from ..train import train_nerf
    from .common import device_line

    cfg = C.load_config(list(overrides), config)
    t0 = time.perf_counter()
    state, history = train_nerf._main(cfg)
    wall = time.perf_counter() - t0
    steps = history["steps"][1:] or history["steps"]
    print(f"fit {config} {' '.join(overrides)}: {len(history['steps'])} "
          f"steps and {len(history['valid'])} validations in {wall:.1f} s "
          f"(dataset synthesis included); step after the first: median "
          f"{1e3 * statistics.median(s['step_s'] for s in steps):.1f} ms, "
          f"waiting for the batch median "
          f"{1e3 * statistics.median(s['data_s'] for s in steps):.2f} ms"
          f" [{device_line(next(state.model.parameters()).device)}]")
    return cfg, state, history


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="a run's validation PSNR beside the JAX record")
    parser.add_argument("run", help="model_path or its metrics.jsonl; with "
                        "--fit, the config to fit")
    parser.add_argument("overrides", nargs="*",
                        help="with --fit: the config's key=value overrides")
    parser.add_argument("--fit", action="store_true")
    parser.add_argument("--config", default="nerf_convergence_hashgrid_cpu",
                        help=f"the run's config, one of {sorted(RECORDS)}; "
                             f"with --fit, the fitted one")
    parser.add_argument("--bar-db", type=float, default=None)
    parser.add_argument("--at", default=None,
                        help="comma-separated epochs to hold")
    args = parser.parse_args(argv)
    run = args.run
    record = record_path(args.run if args.fit else args.config)
    if args.fit:
        logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                            format="%(asctime)s %(levelname)s %(message)s")
        cfg, _, _ = fit(args.run, args.overrides)
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
