"""The port stands alone: no module of tcnerf_torch/, not chip_smoke.py and
not the scripts that drive the port imports JAX, flax, optax, msgpack,
tensorflow or the JAX package (tcnerf)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "tcnerf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# scripts/jax_run.py runs the JAX package; these drive the port alone
PORT_SCRIPTS = [ROOT / "scripts" / name
                for name in ("round_parity.py", "strong_alternate.py")]
BANNED = {"jax", "jaxlib", "flax", "optax", "msgpack", "tensorflow",
          "tcnerf"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", FILES + PORT_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
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


TASK_MODULES = (
    ["tcnerf_torch.tasks." + m for m in (
        "dataclasses", "protocols", "factory", "loader", "agents", "object",
        "oracle", "primitive", "scene", "sensor", "task",
        "transform_utils.random", "transform_utils.differences",
        "plugins.objects.base", "plugins.primitives.pick_and_place",
        "plugins.scenes.virtual", "plugins.oracles.suction_grasp",
        "plugins.oracles.insertion", "plugins.tasks.grasp_task",
        "plugins.tasks.simple_task", "plugins.tasks.box_packing_task",
        "plugins.tasks.kitting_task")]
    + ["tcnerf_torch.data.collect", "tcnerf_torch.core.bounds"])


def test_task_modules_are_covered():
    """The task layer's modules, data collection and the clip helper are
    among the files checked above."""
    for name in TASK_MODULES:
        assert name in MODULES, name


def test_plugins_load_with_jax_blocked():
    """With JAX, flax and the JAX package blocked, the loader resolves the
    port config's plugin names (the JAX package's modules), the
    reference's `manipulation_tasks.plugins.*` names and the short names
    to the port's plugins, and the factory then builds the suction
    oracle; nothing of the JAX package was imported."""
    import subprocess
    import sys
    code = ("import sys\n"
            "for m in ('tcnerf', 'jax', 'flax'):\n"
            "    sys.modules[m] = None\n"
            "from tcnerf_torch.tasks import factory, loader\n"
            "from tcnerf_torch.train.config import load_config\n"
            "names = load_config([], 'goal_1_view').validation.plugins\n"
            "assert all(n.startswith('tcnerf.tasks.') for n in names.plugins)\n"
            "loader.load_plugins(names.plugins)\n"
            "loader.load_plugins(['manipulation_tasks.plugins.tasks."
            "simple_task', 'insertion', 'virtual_scene', 'objects'])\n"
            "o = factory.create_oracle({'oracle_type': "
            "'suction_grasp-oracle', 'gripper_offset': "
            "{'rotation': [3.14159265359, 0.0, 1.57079632679]}})\n"
            "assert type(o).__module__ == "
            "'tcnerf_torch.tasks.plugins.oracles.suction_grasp'\n"
            "factory.create_task_factory({'task_factory_type': "
            "'simple-task-factory', 't_bounds': [[0, 1]] * 3, 'r_bounds': "
            "[[0, 0]] * 3, 'object_types': [], 'n_objects': 0, "
            "'manipulation_type': 'x', 'primitive_type': 'x'})\n"
            "loaded = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('tcnerf', 'jax', 'flax') and sys.modules[m] is not None)\n"
            "assert not loaded, loaded\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_convergence_tool_is_covered():
    """The trained-quality tool (the stage-1 curves, the grasp round
    reader and the strong validation) and the session it reads are among
    the files checked above."""
    for name in ("tcnerf_torch.tools.convergence",
                 "tcnerf_torch.train.session",
                 "tcnerf_torch.train.grasp_common"):
        assert name in MODULES, name
