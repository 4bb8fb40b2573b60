"""Stage-1 NeRF training without CLIP (tcnerf/train/train_without.py): the
`train_nerf` entry on `nerf_1_view_wo`, fusion pinned to "without".

    python -m tcnerf_torch.train.train_without [key=value ...]
"""

from __future__ import annotations

from typing import List, Optional

from .train_nerf import entry


def main(argv: Optional[List[str]] = None):
    return entry(argv, "nerf_1_view_wo", fusion="without")


if __name__ == "__main__":
    main()
