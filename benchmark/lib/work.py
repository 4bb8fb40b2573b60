"""The arithmetic of a unit of work, from the cell's shapes alone.

Model operations are counted by running the plain reference on the `meta`
device under `torch.utils.flop_counter.FlopCounterMode` (matrix products,
convolutions and attention; element-wise work is not counted), so no
kernel of the program enters the count and a later change to the program
leaves it as it is. The swg chunk stage's work is counted by hand from
its shapes: per query the bilinear gather of the pre-projected
`hidden`-wide image, the geometry head (12 * n_freq -> hidden), the chain
of 2 * n_blocks hidden x hidden layers and the readout (hidden -> 4); per
view each stage's image is read once and each query's inputs (pixel xy,
camera-frame position and direction, f32) are read and its 4 outputs
(f32) written once.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def counted_flops(fn: Callable[[], object]) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def chain_query_flops(hidden: int, n_blocks: int, n_freq: int = 10,
                      n_out: int = 4) -> int:
    """Operations of one query through head, chain and readout."""
    return 2 * (12 * n_freq * hidden + 2 * n_blocks * hidden * hidden
                + hidden * n_out)


def view_queries(h: int, w: int, n_samples: int) -> Dict[str, int]:
    """Queries of a full view: n_samples coarse and 2 n_samples fine per
    ray."""
    return {"coarse": h * w * n_samples, "fine": h * w * 2 * n_samples}


def chunk_work(h: int, w: int, n_samples: int, hidden: int, n_blocks: int,
               n_freq: int = 10, image_bytes: int = 2) -> Dict[str, float]:
    """The swg chunks' gather + MLP work of one view (both stages):
    operations and bytes."""
    q = sum(view_queries(h, w, n_samples).values())
    flops = q * chain_query_flops(hidden, n_blocks, n_freq)
    nbytes = 2 * h * w * hidden * image_bytes + q * (8 * 4 + 4 * 4)
    return {"flops": float(flops), "bytes": float(nbytes)}


def projection_flops(h: int, w: int, n_channels: int, hidden: int) -> int:
    """The per-pixel projection of the source image's channels through
    layer_0's feature rows, both stages."""
    return 2 * 2 * h * w * n_channels * hidden


def meta_model(cls, c: dict) -> torch.nn.Module:
    with torch.device("meta"):
        return cls(c)


def encoder_flops(c: dict, n_images: int) -> int:
    from benchmark.reference.encoder import VisualFeatures, full_resolution
    model = meta_model(VisualFeatures, c)
    h, w = c["image_size"]
    x = torch.empty((n_images, h, w, 3), device="meta")
    return counted_flops(lambda: full_resolution(model(x)))


def grasp_request_flops(c: dict, opt: dict) -> Dict[str, float]:
    """One grasp request (features of n_images views, every ascent step's
    energy and its pose gradient, the final energies), all at the
    configuration's float32."""
    from benchmark.reference.grasp import GraspModel, pose_matrix
    model = meta_model(GraspModel, c)
    for p in model.parameters():
        p.requires_grad_(False)
    h, w = c["image_size"]
    n_img, n = opt["n_images"], opt["n_guesses"]
    dev = "meta"
    combined = torch.empty((n_img, h, w, c["n_features"] + 3), device=dev)
    cams = torch.empty((n_img, 1, 4, 4), device=dev)

    def energy(t, q):
        poses = pose_matrix(t, q).expand(n_img, -1, -1, -1)
        return model.energy(poses, combined, cams, cams).sum(0)

    def step():
        t = torch.empty((1, n, 3), device=dev, requires_grad=True)
        q = torch.empty((1, n, 4), device=dev, requires_grad=True)
        with torch.enable_grad():
            torch.autograd.grad(-energy(t, q).sum(), [t, q])

    def final():
        with torch.no_grad():
            energy(torch.empty((1, n, 3), device=dev),
                   torch.empty((1, n, 4), device=dev))

    total = (encoder_flops(c, n_img) + opt["steps"] * counted_flops(step)
             + counted_flops(final))
    return {"float32": float(total)}


def view_flops(c: dict) -> Dict[str, float]:
    """One served view: the encoder at float32, the projection and the
    chunks' MLP work at bfloat16 (the serving path's stream)."""
    h, w = c["image_size"]
    chunks = chunk_work(h, w, c["n_samples"], c["hidden"], c["n_blocks"])
    return {"float32": float(encoder_flops(c, 1)),
            "bfloat16": chunks["flops"] + projection_flops(
                h, w, c["n_features"] + 3, c["hidden"])}


def train_step_flops(c: dict, batch: int, n_rays: int) -> Dict[str, float]:
    """One training step's forward and backward (gradients of every
    parameter and of the activations; no recompute), at float32."""
    from benchmark.reference.nerf import Renderer, loss
    model = meta_model(Renderer, c)
    h, w = c["image_size"]
    dev = "meta"
    batch_in = ((torch.empty((batch, n_rays, 3), device=dev),
                 torch.empty((batch, n_rays, 3), device=dev),
                 torch.empty((batch, 1, h, w, 3), device=dev),
                 torch.empty((batch, 1, 4, 4), device=dev),
                 torch.empty((batch, 1, 4, 4), device=dev)),
                torch.empty((batch, n_rays, 3), device=dev))
    u = torch.empty((batch, n_rays, c["n_samples"]), device=dev)

    def step():
        loss(model, batch_in, u, u).backward()

    return {"float32": float(counted_flops(step))}
