"""Experiment logging with wandb's call surface (tcnerf/utils/wandb_compat.py):
`init(**cfg, resume=True)`, `log(dict)`, `run.finish()`. `init` returns a
local recorder that appends each logged dict to
`<dir>/wandb_local/<project>/wandb_log.jsonl`; a training run depends
neither on the `wandb` package nor on its servers."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class _LocalRun:
    def __init__(self, log_dir: str, config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "wandb_log.jsonl")
        self.config = config or {}
        with open(os.path.join(log_dir, "wandb_config.json"), "w") as f:
            json.dump({k: str(v) for k, v in self.config.items()}, f)

    def log(self, metrics: dict):
        record = {"_time": time.time()}
        record.update({k: float(v) if hasattr(v, "__float__") else v
                       for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def finish(self):
        pass


_active_run: Optional[_LocalRun] = None


def init(project: str = "tcnerf", dir: str = ".",
         config: Optional[dict] = None, resume: bool = True,
         **kwargs) -> _LocalRun:
    global _active_run
    _active_run = _LocalRun(os.path.join(dir, "wandb_local", project), config)
    return _active_run


def log(metrics: dict):
    if _active_run is not None:
        _active_run.log(metrics)


def init_wandb(wandb_config: dict):
    """(the run, whether it logs)."""
    return init(**wandb_config), True
