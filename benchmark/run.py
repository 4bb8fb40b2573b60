"""The benchmark of tcnerf_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `benchmark/` and
`tcnerf_torch/`. It finds the cell's configuration, traffic mix and
metrics by their names in `BENCHMARK.json` (`lib/registry.py`), makes the
weights and inputs from the seed, sets up and warms up the program (set-up
time is `setup_s`, from the start of this process), then measures for
`--seconds`: each unit of work (a request or a training step) is timed,
and the window closes when the unit in flight at `--seconds` completes.
With `--trace 1` the program's functions named by the cell's metrics are
wrapped with CUDA events during the window, and a profiled segment of a
fixed count of units follows it. Then the program's outputs are held
against the plain reference (`reference/`), with the program freed first.

Prints, as its last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics, or with
`--trace 1` the per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`: each number compared, with its limit; the same numbers
are the last lines of standard error. Exits non-zero, printing no result,
without a card (or with fewer than the cell asks for), when a named file
is missing, and when a JAX module or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# a library the port uses must not bring JAX in by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def pin(n: int) -> str:
    """Pins this process, and every thread it starts from here on, to the
    last `n` of the cores it may run on; a fixed set, so that the host's
    scheduler does not move the launching thread between runs."""
    cores = sorted(os.sched_getaffinity(0))[-n:]
    os.sched_setaffinity(0, cores)
    return ",".join(map(str, cores))


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.lib import registry

    try:
        cell = registry.find_cell(args.workload)
    except registry.RegistryError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    cores = cell.checks.get("host_cores")
    if cores:
        # before torch starts a thread: threads inherit the calling one's
        print(f"benchmark: pinned to cores {pin(int(cores))}",
              file=sys.stderr)
    import torch

    # one host thread for PyTorch's CPU work: the card's work is launched
    # from the main thread, and a pool of spinning workers beside it on a
    # shared host makes the host-bound views' latency swing from run to run
    torch.set_num_threads(1)

    from benchmark.lib import guard, harness

    chips = int(cell.spec.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    print(f"benchmark: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr)
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace),
                              device=torch.device("cuda"), t_start=T0)
    found = guard.loaded()
    if found:
        print(f"benchmark: banned modules loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
