"""Device selection for the port's public entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

from .core.prec import pin_fp32


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another. Raises when CUDA was asked for (or defaulted to) and no card is
    present — the port never carries on on the CPU by itself.

    Also pins fp32 matmuls/convolutions to full precision (core/prec.py)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tcnerf_torch: CUDA device requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU")
    pin_fp32()
    return dev
