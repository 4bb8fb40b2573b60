"""The port stands alone: no module of tcnerf_torch/ and not chip_smoke.py
imports JAX, flax, optax, msgpack, tensorflow or the JAX package
(tcnerf)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "tcnerf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "msgpack", "tensorflow",
          "tcnerf"}


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


MODULES = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                 for p in FILES if p.parent != ROOT)


def test_grasp_and_fused_training_modules_are_covered():
    """The grasp serving stack and the fused trainers' modules are among
    the files checked above."""
    for name in ("tcnerf_torch.core.se3", "tcnerf_torch.tasks.transform",
                 "tcnerf_torch.nn.grasp_readout", "tcnerf_torch.models.grasp",
                 "tcnerf_torch.opt.pose_optimizer",
                 "tcnerf_torch.models.pipeline",
                 "tcnerf_torch.train.grasp_common",
                 "tcnerf_torch.train.train_without",
                 "tcnerf_torch.data.prefetch", "tcnerf_torch.clip.unicode_ln"):
        assert name in MODULES, name


def test_grasp_training_modules_are_covered():
    """The grasp trainers' modules are among the files checked above."""
    for name in ("tcnerf_torch.models.grasp_training",
                 "tcnerf_torch.train.session",
                 "tcnerf_torch.train.train_goal",
                 "tcnerf_torch.train.train_delta_ngf",
                 "tcnerf_torch.train.train_trajectory",
                 "tcnerf_torch.train.train_language",
                 "tcnerf_torch.tasks.agents",
                 "tcnerf_torch.utils.wandb_compat",
                 "tcnerf_torch.data.generators", "tcnerf_torch.data.loaders",
                 "tcnerf_torch.data.dataset", "tcnerf_torch.data.synthetic"):
        assert name in MODULES, name


def test_hashgrid_modules_are_covered():
    """The hash-grid modules are among the files checked above."""
    for name in ("tcnerf_torch.ops.hashgrid",
                 "tcnerf_torch.nn.hashgrid_field"):
        assert name in MODULES, name


def test_checkpoint_modules_are_covered():
    """The checkpoint modules are among the files checked above."""
    for name in ("tcnerf_torch.models.msgpack_codec",
                 "tcnerf_torch.models.tf_checkpoint",
                 "tcnerf_torch.models.checkpoint", "tcnerf_torch.params"):
        assert name in MODULES, name


def test_every_module_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter in which
    JAX, flax, optax, msgpack, tensorflow and the JAX package cannot be
    imported at all (not even through another module)."""
    import subprocess
    import sys
    code = ("import importlib, sys\n"
            f"for m in {sorted(BANNED)!r}:\n"
            "    sys.modules[m] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
