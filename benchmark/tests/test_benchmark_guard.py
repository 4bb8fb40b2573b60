"""The import check: top-level module names compared whole. Nothing the
benchmark runs loads `jax` or the JAX package `tcnerf`; the plain
reference loads neither, nor the port `tcnerf_torch`."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.lib import guard

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_names_compared_whole():
    mods = {"tcnerf_torch": 1, "tcnerf_torch.models": 1, "jaxlib.xla": 1,
            "flax": 1, "tcnerf.ops": 1, "jaxtyping": 1, "tcnerfx": 1}
    assert guard.loaded(modules=mods) == ["flax", "jaxlib.xla", "tcnerf.ops"]
    assert guard.loaded(guard.BANNED_FOR_REFERENCE, mods) == [
        "flax", "jaxlib.xla", "tcnerf.ops", "tcnerf_torch",
        "tcnerf_torch.models"]


def imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_sources_import_no_banned_package(path):
    banned = (guard.BANNED_FOR_REFERENCE if path.startswith("reference/")
              else guard.BANNED)
    names = list(imported_names(BENCH / path))
    assert not [n for n in names if guard.top_level(n) in banned]


def run_python(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "HOME": str(ROOT)})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_banned():
    code = ("import json\n"
            "import benchmark.reference.grasp, benchmark.reference.nerf\n"
            "import benchmark.reference.train\n"
            "from benchmark.lib import guard\n"
            "print(json.dumps(guard.loaded(guard.BANNED_FOR_REFERENCE)))\n")
    assert run_python(code) == []


def test_a_run_loads_nothing_banned():
    code = ("import json, time, torch\n"
            "from benchmark.tests import tiny\n"
            "from benchmark.lib import guard\n"
            "tiny.run('goal_1_view.infer')\n"
            "print(json.dumps(guard.loaded()))\n")
    assert run_python(code) == []
