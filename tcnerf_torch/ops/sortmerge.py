"""Per-ray sorts (tcnerf/ops/sortmerge.py).

The JAX package ranks with compare-sums and permutes with one-hot matmuls
because the TPU's variadic sort is slow; on the card `torch.sort` is the
plain tool. Both functions sort the last axis ascending.
"""

from __future__ import annotations

import torch


def sort_small(values: torch.Tensor) -> torch.Tensor:
    """Stable ascending sort of the last axis."""
    return torch.sort(values, dim=-1, stable=True).values


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sorted union of two ascending-sorted arrays along the last axis."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True).values
