"""Cells cut to a size the CPU runs in seconds, for the harness's tests."""

from __future__ import annotations

import time

import torch

from benchmark.lib import harness, registry

TINY = {"image_size": [48, 64], "n_features": 32, "hidden": 32,
        "n_blocks": 2, "vit_size": [32, 32], "vit_dim": 32, "vit_heads": 2,
        "vit_hooks": [1, 2, 3, 4]}
EXTRA = {"goal_1_view.infer": {"n_5d_poses": 3, "n_guesses": 64, "steps": 3},
         "nerf_1_view_wo.view": {"n_samples": 8, "chunk": 1024},
         "nerf_1_view_wo.train": {"n_samples": 8, "n_rays": 32,
                                  "batch_size": 2, "n_scenes": 2}}
CELLS = sorted(EXTRA)
SEED = 2 ** 31 + 77                # above 32 signed bits, as the driver's

# what the drivers' planted faults replace, restored after each test
FAULT_TARGETS = (
    ("tcnerf_torch.opt.pose_optimizer", "PoseOptimizer", "optimize_pose"),
    ("tcnerf_torch.models.pipeline", "GraspPipeline", "infer"),
    ("tcnerf_torch.models.inference", None, "render_view"),
    ("tcnerf_torch.models.training", "NerfOptimizer", "step"),
    ("tcnerf_torch.models.training", None, "nerf_loss"),
    ("tcnerf_torch.models.training", None, "nerf_train_step"),
)


def cell(name: str) -> registry.Cell:
    c = registry.find_cell(name)
    c.config = dict(c.config, **TINY, **EXTRA[name])
    c.traffic = dict(c.traffic, warmup_units=min(
        int(c.traffic.get("warmup_units", 1)), 3), trace_units=1)
    return c


def run(name: str, trace: bool = False, faults=()) -> harness.Result:
    return harness.run_cell(cell(name), seed=SEED, seconds=0.3, trace=trace,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(), faults=faults)


def keep_fault_targets(monkeypatch) -> None:
    import importlib
    for module, owner, attr in FAULT_TARGETS:
        obj = importlib.import_module(module)
        if owner:
            obj = getattr(obj, owner)
        monkeypatch.setattr(obj, attr, getattr(obj, attr))


def emitted(result: harness.Result):
    import io
    import json
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, out, err)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()
