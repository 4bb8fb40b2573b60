"""On the card: each cell's run from the command line, and, through the
harness, the same cell with its control (the reference in the nearest
lower precision in the program's place), which comes out not correct. Marked
`gpu`; each test decides for itself whether a card is there.

    python3 -m pytest benchmark/tests -m gpu -p no:cacheprovider
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.lib import registry

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name, cuda):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483731", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-3000:]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cuda):
    from benchmark.lib import harness
    cell = registry.find_cell(name)
    control = harness.run_cell(cell, 2147483737, 3.0, False, cuda,
                               time.perf_counter(), control=True)
    assert control.correct is False, control.checks
