"""Full-fp32 linear algebra for geometry.

Counterpart of tcnerf/core/prec.py, which pins `Precision.HIGHEST` on every
geometry einsum: a 2.5e-3 relative error on a 640-px projection is a
multi-pixel gather offset. On the card a float32 convolution runs in TF32
by default (cuDNN), and a float32 matmul would too if `allow_tf32` were set;
TF32 keeps ~3 decimal digits. `pin_fp32` turns both off for the process.
Every public entry point calls it (device.resolve_device), so the reference
and geometry paths always run in true fp32. Neural layers that want reduced
precision ask for it explicitly with a bf16 compute dtype.
"""

import torch


def pin_fp32() -> None:
    """Disable TF32 for float32 matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
