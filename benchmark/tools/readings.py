"""The readings a cell's limits are set from, at the cell's own size.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control-seeds 1,2,3] [--fault <name>] \
        [--out <file.jsonl>]

In one process, one run of the harness (`lib/harness.py` `run_cell`: set-up,
a short window at the cell's load, the program freed, the check) per seed:
the program on `--seeds`, the control (the reference in the nearest lower
precision in the program's place, from the cell's file under
`benchmark/cells/`) on `--control-seeds`, and with `--fault` the program
with that fault planted in the timed path (the drivers' `plant_faults`).
One JSON line per run, with every number the check computes and whether
the run came out correct. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, seconds: float, device, control: bool = False,
             faults=()) -> dict:
    from benchmark.lib import harness

    t0 = time.perf_counter()
    r = harness.run_cell(cell, seed=seed, seconds=seconds, trace=False,
                         device=device, t_start=t0, faults=faults,
                         control=control)
    mode = "control" if control else "fault" if faults else "program"
    return dict({k: c["value"] for k, c in r.checks.items()}, **r.info,
                workload=cell.name, seed=seed, mode=mode,
                faults=sorted(faults), correct=r.correct,
                units=r.attempted, failed=r.failed,
                memory_peak_bytes=r.device["memory_peak_bytes"],
                run_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(1)            # as benchmark/run.py

    from benchmark.lib import registry

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.find_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    runs = [(s, False) for s in seeds] + [
        (int(s), True) for s in args.control_seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None
    for seed, control in runs:
        line = readings(cell, seed, args.seconds, torch.device("cuda"),
                        control, () if control else args.fault)
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
