"""Language-conditioned grasp-field training (tcnerf/train/train_language.py):
the delta-NGF trainer on `language_1_view` with CLIP text conditioning
through the fusion decoder of `grasp_training.fusion` (default v4), the
instructions through the port's tokenizer, and alternating t / r
validation ascent (sync off).

    python -m tcnerf_torch.train.train_language [--config-name=<name>] [key=value ...]
"""

from __future__ import annotations

from typing import List, Optional

from ..clip.tokenizer import tokenize
from ..data.generators import LanguageDataGenerator
from .grasp_common import GraspRun, entry
from .train_delta_ngf import run_delta_training


def run_language_training(cfg, device=None) -> GraspRun:
    return run_delta_training(
        cfg, generator_cls=LanguageDataGenerator, sync=False,
        fusion=cfg.grasp_training.get("fusion", "v4"), tokenize_fn=tokenize,
        wandb_project="nerf-manipulation", device=device)


def main(argv: Optional[List[str]] = None):
    return entry(argv, "language_1_view", run_language_training)


if __name__ == "__main__":
    main()
