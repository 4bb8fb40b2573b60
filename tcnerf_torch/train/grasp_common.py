"""The grasp entry points' shared parts (tcnerf/train/grasp_common.py):
`build_grasp_model`. The oracle and validation loops wait for the grasp
data generators and task plugins (ROADMAP Queue A item 2.4)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import resolve_device
from ..models.grasp import GraspEBM
from ..params import init_params


def build_grasp_model(cfg, fusion: Optional[str] = None,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> GraspEBM:
    """The GraspEBM of `cfg` (tcnerf/train/grasp_common.py:22-79
    `build_grasp_model`): the backbone's widths from `nerf_model`, the probe
    grid from `grasp_model`, and the readout flavour of
    `grasp_training.readout_flavor` ("goal": elu, glorot, bias; otherwise
    the delta-NGF / language flavour: elu, he_normal, the bias from
    `grasp_training.readout_bias`). `corner_gather` follows
    `grasp_training.train_fusion` unless set. A hash-grid `grasp_model`
    raises (not ported). The model lives on `device` (the card unless the
    caller passes "cpu"; `device.resolve_device`, which also pins fp32) with
    weights seeded from `cfg.seed` (`params.init_params`), as
    `train_nerf.build_model` seeds the renderer."""
    nm = cfg.nerf_model
    gm = cfg.grasp_model
    gt = cfg.grasp_training
    if gm.get("encoding", "fourier") == "hashgrid":
        raise NotImplementedError("the hash-grid grasp field is not ported")
    train_fusion = gt.get("train_fusion", False)
    kwargs = dict(
        n_views=nm.n_views, n_features=nm.n_features,
        original_image_size=tuple(nm.original_image_size),
        n_5d_poses=gm.n_5d_poses,
        n_blocks=nm.get("n_blocks", 6),
        hidden_size=nm.get("hidden_size", 128),
        vit_size=tuple(nm.get("vit_size", (224, 224))),
        vit_patch=nm.get("vit_patch", 16), vit_dim=nm.get("vit_dim", 768),
        vit_heads=nm.get("vit_heads", 12),
        vit_hooks=tuple(nm.get("vit_hooks", (3, 6, 9, 12))),
        fusion=fusion,
        clip_layers=tuple(nm.get("clip_layers", (3, 4, 6, 3))),
        clip_width=nm.get("clip_width", 64),
        clip_embed_dim=nm.get("clip_embed_dim", 1024),
        clip_text_width=nm.get("clip_text_width", 512),
        clip_text_layers=nm.get("clip_text_layers", 12),
        clip_image_size=nm.get("clip_image_size", 224),
        remat_fusion=train_fusion,
        corner_gather=gt.get("corner_gather", not train_fusion),
    )
    if gt.get("readout_flavor", "dngf") == "goal":
        kwargs.update(readout_activation="elu", readout_use_bias=True,
                      readout_kernel_init="glorot_uniform")
    else:
        kwargs.update(readout_activation="elu",
                      readout_kernel_init="he_normal",
                      readout_use_bias=gt.get("readout_bias", False))
    dev = resolve_device(device)
    model = GraspEBM(**kwargs).to(dev)
    init_params(model, torch.Generator(device=dev).manual_seed(
        cfg.get("seed", 0)))
    return model
