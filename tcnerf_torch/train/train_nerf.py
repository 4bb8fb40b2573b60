"""Stage-1 NeRF training (tcnerf/train/train_nerf.py).

    python -m tcnerf_torch.train.train_nerf [key=value ...]

runs on the card; `device=cpu` runs on the CPU, e.g. at a tiny size:

    python -m tcnerf_torch.train.train_nerf device=cpu data_dir=/tmp/run \\
        'nerf_model.original_image_size=[48,64]' nerf_model.n_samples=8 \\
        nerf_model.n_rays_train=32 'nerf_model.vit_size=[32,32]' \\
        nerf_model.vit_dim=32 nerf_model.vit_heads=2 \\
        'nerf_model.vit_hooks=[1,2,3,4]' nerf_model.n_blocks=2 \\
        nerf_training.n_epochs=2 nerf_training.eval_after_epochs=1 \\
        nerf_training.batch_size=1 nerf_training.warmup_steps=5 \\
        dataset.n_perspectives=6 dataset.n_synthetic_samples=2 \\
        valid_sample_idx=0 'valid_perspective_src_indices=[1]' \\
        valid_perspective_tgt_idx=4

The configuration is `train/config.py`'s `nerf_1_view_wo` with overrides.
`build_model` takes the JAX trainer's knobs and defaults: `remat` and the
4-tap gather (`corner_gather` off), the plain chain (`pallas_mlp` off;
`nerf_model.pallas_mlp=true` runs the chain halves through K1',
ops/resmlp.py `resmlp_rows_diff`) and `fusion` "v0" where the config names
none. Datasets are synthesized when `dataset.path`
holds none. Each fit round of `eval_after_epochs` epochs ends with a
validation render through `render_view` and its PSNR; a validation runs
before the first round too.

Not here, because their file formats need packages the card's machine
lacks: checkpoints and resuming (flax msgpack) and the PNG validation strip
(PIL). Training is held against the JAX trainer for fusion "without" only;
the CLIP-fused models (`fusion` v0-v4) are not compared in training yet.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Dict, List, Optional

import torch

from ..data.generators import MVNeRFDataGenerator, to_device
from ..data.loaders import ensure_dataset, load_dataset_nerf
from ..device import resolve_device
from ..models import training as T
from ..models.inference import psnr, render_view
from ..models.renderer import MVNeRFRenderer
from ..params import init_params
from .config import load_config

log = logging.getLogger("tcnerf_torch.train")


def build_model(cfg, device: torch.device) -> MVNeRFRenderer:
    """The renderer of `cfg.nerf_model` on `device`, seeded weights. Every
    knob and default is tcnerf/train/train_nerf.py `build_model`'s."""
    nm = cfg.nerf_model
    model = MVNeRFRenderer(
        n_views=nm.n_views, n_samples=nm.n_samples, n_features=nm.n_features,
        near=nm.near, far=nm.far,
        original_image_size=tuple(nm.original_image_size),
        fusion=cfg.nerf_training.get("fusion", "v0"),
        n_blocks=nm.get("n_blocks", 6), hidden_size=nm.get("hidden_size", 128),
        vit_size=tuple(nm.get("vit_size", (224, 224))),
        vit_patch=nm.get("vit_patch", 16), vit_dim=nm.get("vit_dim", 768),
        vit_heads=nm.get("vit_heads", 12),
        vit_hooks=tuple(nm.get("vit_hooks", (3, 6, 9, 12))),
        clip_layers=tuple(nm.get("clip_layers", (3, 4, 6, 3))),
        clip_width=nm.get("clip_width", 64),
        clip_embed_dim=nm.get("clip_embed_dim", 1024),
        clip_image_size=nm.get("clip_image_size", 224),
        fusion_use_dense=nm.get("fusion_use_dense", False),
        fusion_activation=nm.get("fusion_activation", "relu"),
        corner_gather=nm.get("corner_gather", False),
        remat=nm.get("remat", True), pallas_mlp=nm.get("pallas_mlp", False),
        encoder_dtype=nm.get("encoder_dtype", None),
        field=nm.get("field", "pixel"),
        hashgrid_levels=nm.get("hashgrid_levels", 16),
        hashgrid_table_log2=nm.get("hashgrid_table_log2", 14),
        hashgrid_hidden=nm.get("hashgrid_hidden", 64),
        hashgrid_layers=nm.get("hashgrid_layers", 3),
        hashgrid_bounds=tuple(tuple(b) for b in nm.get(
            "hashgrid_bounds", ((-0.2, 1.2), (-0.8, 0.8), (-0.4, 1.0))))
    ).to(device)
    init_params(model, torch.Generator(device=device).manual_seed(
        cfg.get("seed", 0)))
    return model


def load_validation(cfg, dataset) -> Dict:
    """The validation scene's source views, cameras and target view."""
    src_idx = cfg.valid_perspective_src_indices[:cfg.nerf_model.n_views]
    colors = dataset.datasets["color"]
    cameras = dataset.datasets["camera_config"]
    i, tgt = cfg.valid_sample_idx, cfg.valid_perspective_tgt_idx
    return {"src_colors": [colors.read_sample_at_idx(i, s) for s in src_idx],
            "src_camera_configs": [cameras.read_sample_at_idx(i, s)
                                   for s in src_idx],
            "tgt_camera_config": cameras.read_sample_at_idx(i, tgt),
            "tgt_colors": colors.read_sample_at_idx(i, tgt)}


def run_validation(model, valid_data, device, generator) -> float:
    """Render the validation target view; its PSNR against the capture."""
    rgb, _ = render_view(model, valid_data["src_colors"],
                         valid_data["src_camera_configs"],
                         valid_data["tgt_camera_config"], generator=generator,
                         device=device)
    return psnr(rgb, valid_data["tgt_colors"][..., :3])


def train_model(state: T.TrainState, data_generator: MVNeRFDataGenerator,
                cfg, valid_data, device: torch.device,
                generator: torch.Generator) -> Dict[str, List]:
    """n_epochs // eval_after_epochs fit rounds of eval_after_epochs epochs.
    Returns the history: per step its loss and host seconds (batch
    synthesis `data_s`, the whole step `step_s`, ending when the loss has
    reached the host), and per validation (epoch, PSNR dB)."""
    nt = cfg.nerf_training
    history: Dict[str, List] = {"steps": [], "valid": []}
    value = run_validation(state.model, valid_data, device, generator)
    history["valid"].append((0, value))
    log.info("validation PSNR before training: %.2f dB", value)
    for k in range(nt.n_epochs // nt.eval_after_epochs):
        for _ in range(nt.eval_after_epochs):
            for i in range(len(data_generator)):
                t0 = time.perf_counter()
                inputs, labels = to_device(*data_generator[i], device)
                t_data = time.perf_counter() - t0
                state, metrics = T.nerf_train_step(state, inputs, labels,
                                                   generator)
                loss = float(metrics["loss"])
                history["steps"].append(dict(
                    step=state.step, loss=loss, data_s=t_data,
                    step_s=time.perf_counter() - t0))
            data_generator.on_epoch_end()
        epoch = (k + 1) * nt.eval_after_epochs
        log.info("epoch %d: loss %.5f", epoch, history["steps"][-1]["loss"])
        value = run_validation(state.model, valid_data, device, generator)
        history["valid"].append((epoch, value))
        log.info("validation PSNR after epoch %d: %.2f dB", epoch, value)
    return history


def _main(cfg, device: Optional[torch.device] = None):
    """Data, model and optimizer from `cfg`, then `train_model`. Returns
    (state, history)."""
    dev = resolve_device(device or cfg.get("device"))
    nm = cfg.nerf_model
    span = cfg.dataset.get("azimuth_span_deg")
    size = tuple(nm.original_image_size)
    n_persp = cfg.dataset.n_perspectives
    ensure_dataset(cfg.dataset.path + "/train", n_persp, image_size=size,
                   n_samples=cfg.dataset.get("n_synthetic_samples", 8),
                   azimuth_span_deg=span)
    ensure_dataset(cfg.dataset.path + "/valid", n_persp, image_size=size,
                   n_samples=max(cfg.get("valid_sample_idx", 3) + 1, 4),
                   rng=1, azimuth_span_deg=span)
    train_data = load_dataset_nerf(n_persp, cfg.dataset.path + "/train")
    valid_data = load_validation(
        cfg, load_dataset_nerf(n_persp, cfg.dataset.path + "/valid"))
    seed = cfg.get("seed", 0)
    data_generator = MVNeRFDataGenerator(
        train_data, n_rays_train=nm.n_rays_train,
        batch_size=cfg.nerf_training.batch_size, n_views=nm.n_views,
        shuffle=True, rng=seed)
    model = build_model(cfg, dev)
    nt = cfg.nerf_training
    state = T.create_train_state(model, T.make_nerf_optimizer(
        model, nerf_lr=nt.get("learning_rate", 1e-4),
        feature_lr=nt.get("feature_learning_rate", 1e-5),
        warmup_steps=nt.get("warmup_steps", 10000),
        scale_down_after=nt.get("scale_down_after", 450000)))
    log.info("New model initialized (seeded random weights) on %s", dev)
    history = train_model(state, data_generator, cfg, valid_data, dev,
                          torch.Generator(device=dev).manual_seed(seed + 1))
    return state, history


def main(argv: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(message)s")
    return _main(load_config(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
