"""The port stands alone: no module of tcnerf_torch/ and not chip_smoke.py
imports JAX, flax, optax or the JAX package (tcnerf)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "tcnerf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "tcnerf"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_files_found():
    assert len(FILES) > 10
