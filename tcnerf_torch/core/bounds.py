"""`jnp.clip` / `jnp.maximum` / `jnp.minimum` with JAX's gradient at a tie.

`torch.clamp` passes the whole gradient to x where x equals a bound; JAX's
`maximum` and `minimum` (and so `clip`, which is one then the other) pass
half of it. `torch.maximum` / `torch.minimum` split a tie in half as JAX
does, and give the forward the same bits as `torch.clamp`. Their backward
is itself differentiable, so second-order paths keep the split too.
"""

from __future__ import annotations

from typing import Optional

import torch


def clip(x: torch.Tensor, lo: Optional[float] = None,
         hi: Optional[float] = None) -> torch.Tensor:
    """x clipped to [lo, hi] (either bound may be None), each bound a 0-d
    tensor of x's dtype and device, as `jnp.clip(x, lo, hi)`."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x
