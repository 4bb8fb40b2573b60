"""Published peaks of one NVIDIA H100 SXM and the least time they allow.

Copied from `tcnerf_torch/tools/common.py` (`PEAK_BF16_FLOPS`, `PEAK_BYTES`,
`bound_ms`) and frozen here, with the float32 peak added: the grasp ascent,
the encoder and the stage-1 step compute in float32 with TF32 off, which
runs on the FMA units and not on the tensor cores. Dense rates, no
sparsity, at the card's full 700 W; each run prints the card's power limit.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS: Dict[str, float] = {
    "bfloat16": 989e12,     # tensor cores
    "float32": 67e12,       # outside the tensor cores (TF32 off)
}
PEAK_BYTES = 3.35e12        # HBM3


def least_ms(flops_by_dtype: Dict[str, float]) -> float:
    """The least time, in ms, of work whose operations run at the peak of
    their precision one after another."""
    return sum(f / PEAK_FLOPS[d] for d, f in flops_by_dtype.items()) * 1e3


def bound_ms(flops: float, nbytes: float, dtype: str = "bfloat16"
             ) -> Tuple[float, str]:
    """Least time on the card: max(operations at the peak of `dtype`, bytes
    at the memory rate), in ms, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
