"""The import check: which banned packages a process has loaded.

A module's top-level name is the part of its name before the first dot,
compared whole: `tcnerf_torch` is not `tcnerf`.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

# the JAX stack and the JAX package this port was made from
BANNED = ("jax", "jaxlib", "flax", "tcnerf")
# the plain reference must not lean on the program it judges either
BANNED_FOR_REFERENCE = BANNED + ("tcnerf_torch",)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(banned: Iterable[str] = BANNED, modules=None) -> List[str]:
    """Sorted names in `modules` (default `sys.modules`) whose top-level
    name is one of `banned`."""
    banned = set(banned)
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in banned)
