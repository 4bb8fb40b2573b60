"""Stage-1 NeRF training (tcnerf/train/train_nerf.py).

    python -m tcnerf_torch.train.train_nerf [--config-name=<name>] [key=value ...]

runs on the card; `device=cpu` runs on the CPU, e.g. at a tiny size:

    python -m tcnerf_torch.train.train_nerf device=cpu data_dir=/tmp/run \\
        'nerf_model.original_image_size=[48,64]' nerf_model.n_samples=8 \\
        nerf_model.n_rays_train=32 'nerf_model.vit_size=[32,32]' \\
        nerf_model.vit_dim=32 nerf_model.vit_heads=2 \\
        'nerf_model.vit_hooks=[1,2,3,4]' nerf_model.n_blocks=2 \\
        'nerf_model.clip_layers=[1,1,1,1]' nerf_model.clip_width=8 \\
        nerf_model.clip_embed_dim=32 nerf_model.clip_image_size=32 \\
        nerf_training.n_epochs=2 nerf_training.eval_after_epochs=1 \\
        nerf_training.warmup_steps=5 \\
        dataset.n_perspectives=6 dataset.n_synthetic_samples=2 \\
        valid_sample_idx=0 'valid_perspective_src_indices=[1]' \\
        valid_perspective_tgt_idx=4

The configuration is `nerf_1_view` (fusion v0, batch 1), as the JAX entry
point's; `--config-name=` picks another of `train/config.py`'s stage-1
configs (`nerf_3_view`, `nerf_1_view_v4_elu`, `nerf_1_view_wo`, the
convergence runs `nerf_convergence` (full width, 128 scenes on a 100-degree
arc) and its CPU-sized `nerf_convergence_cpu`, and the hash-grid fast
field's `nerf_convergence_hashgrid` and its CPU-sized
`nerf_convergence_hashgrid_cpu`: one scene, validated on a view of it the
generator never draws, `valid_from_train`), and
`train_without` is this entry pinned to `nerf_1_view_wo` and fusion
"without". `build_model` takes the JAX trainer's knobs and defaults: `remat`
and the 4-tap gather (`corner_gather` off), the plain chain (`pallas_mlp`
off; `nerf_model.pallas_mlp=true` runs the chain halves through K1',
ops/resmlp.py `resmlp_rows_diff`) and `fusion` "v0" where the config names
none. The frozen CLIP tower runs without autograd (renderer.py
`combine_features`). Datasets are synthesized when `dataset.path` holds
none. Batches come through `data/prefetch.py` `prefetched_epochs`. Each fit
round of `eval_after_epochs` epochs ends with a validation render through
`render_view`, its PSNR and the strip `<model_path>/valid/valid-<epoch>.png`
(source views, target, render, depth; written with the stdlib, as the
card's machine has no PIL); a validation runs before the first round too.
Each validation appends a line to `<model_path>/metrics.jsonl`
(`tcnerf_torch/tools/convergence.py` prints it beside the JAX package's
record of the same config). With `TCNERF_TRACE=<logdir>` the steps of the
run's first fit round are traced (`utils/profiling.py` `trace`: host and
card, a Chrome trace file in `<logdir>`).

Checkpoints are the JAX package's files (`models/checkpoint.py`): after
each round the trainer writes `{"epoch": e}` to
`<model_path>/training_progress.json`, stores `<model_path>/model_final`
(`RENDERER_WITHOUT_COMPONENTS` for fusion "without", else
`RENDERER_COMPONENTS`; the components the model lacks, every tower of a
hash-grid model, get no file) and its flavour sidecar
`model_final_meta.json`.
At start `_main` loads `model_final` where it is; otherwise it takes the
ViT of `torch_weights_path` (a timm ViT-B state_dict) where that file is,
else keeps the seeded weights. A run into a directory with a progress file
resumes: the fit rounds start at its epoch and the epoch-0 validation is
skipped. As in the JAX package, a resumed run starts a fresh optimizer
state: Adam's moments and the warm-up count begin again.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import struct
import sys
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.generators import MVNeRFDataGenerator
from ..data.loaders import ensure_dataset, load_dataset_nerf
from ..data.prefetch import prefetched_epochs
from ..device import resolve_device
from ..models import checkpoint as ckpt
from ..models import training as T
from ..models.inference import psnr, render_view
from ..models.renderer import MVNeRFRenderer
from ..params import init_params
from ..utils.profiling import trace
from .config import load_config, parse_argv
from .session import init_training_session

log = logging.getLogger("tcnerf_torch.train")


def build_model(cfg, device: torch.device,
                fusion: Optional[str] = None) -> MVNeRFRenderer:
    """The renderer of `cfg.nerf_model` on `device`, seeded weights. Every
    knob and default is tcnerf/train/train_nerf.py `build_model`'s;
    `fusion` overrides `cfg.nerf_training.fusion`."""
    nm = cfg.nerf_model
    model = MVNeRFRenderer(
        n_views=nm.n_views, n_samples=nm.n_samples, n_features=nm.n_features,
        near=nm.near, far=nm.far,
        original_image_size=tuple(nm.original_image_size),
        fusion=fusion or cfg.nerf_training.get("fusion", "v0"),
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


def write_png(path: str, image: np.ndarray) -> None:
    """An [H, W, 3] uint8 image as an 8-bit RGB PNG (no filter, zlib)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    if c != 3:
        raise ValueError(f"write_png takes [H, W, 3] images, got {image.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def save_validation_strip(path, src_colors, tgt_color, rendered_rgb,
                          rendered_depth) -> None:
    """Side-by-side source views / target / render / depth PNG
    (tcnerf/train/train_nerf.py:82-92)."""
    parts = [np.asarray(c)[..., :3] for c in src_colors]
    parts.append(np.asarray(tgt_color)[..., :3])
    parts.append(rendered_rgb)
    parts.append(np.repeat(rendered_depth, 3, axis=-1))
    write_png(path, np.concatenate(parts, axis=1))


def run_validation(model, valid_data, device, generator, out_path) -> float:
    """Render the validation target view, write its strip to `out_path`;
    its PSNR against the capture."""
    rgb, depth = render_view(model, valid_data["src_colors"],
                             valid_data["src_camera_configs"],
                             valid_data["tgt_camera_config"],
                             generator=generator, device=device)
    save_validation_strip(out_path, valid_data["src_colors"],
                          valid_data["tgt_colors"], rgb, depth)
    value = psnr(rgb, valid_data["tgt_colors"][..., :3])
    log.info("validation PSNR: %.2f dB -> %s", value, out_path)
    return value


def renderer_components(model: MVNeRFRenderer):
    """The checkpoint components of a renderer of `model.fusion`."""
    return (ckpt.RENDERER_WITHOUT_COMPONENTS if model.fusion == "without"
            else ckpt.RENDERER_COMPONENTS)


def train_model(state: T.TrainState, data_generator: MVNeRFDataGenerator,
                cfg, valid_data, device: torch.device,
                generator: torch.Generator) -> Dict[str, List]:
    """The fit rounds from the one `training_progress.json` records to
    n_epochs // eval_after_epochs, each of eval_after_epochs epochs fed by
    `prefetched_epochs` and followed by a validation, the progress file and
    the checkpoint `model_final` with its sidecar. Returns the history: per
    step its loss and host seconds (`data_s`, the wait for the prefetched
    batch; `step_s`, the whole step, ending when the loss has reached the
    host), and per validation (epoch, PSNR dB)."""
    nt = cfg.nerf_training
    model = state.model
    start_epoch, progress_file = init_training_session(nt.model_path)
    checkpoint = os.path.join(nt.model_path, "model_final")
    history: Dict[str, List] = {"steps": [], "valid": []}
    valid_dir = os.path.join(nt.model_path, "valid")
    os.makedirs(valid_dir, exist_ok=True)
    metrics_file = os.path.join(nt.model_path, "metrics.jsonl")

    def validate(epoch: int, loss: Optional[float]) -> None:
        value = run_validation(state.model, valid_data, device, generator,
                               os.path.join(valid_dir, f"valid-{epoch}.png"))
        history["valid"].append((epoch, value))
        with open(metrics_file, "a") as f:
            json.dump({"epoch": epoch, "loss": loss, "psnr_db": value,
                       "t": time.time()}, f)
            f.write("\n")

    if start_epoch == 0:
        validate(0, None)
    # TCNERF_TRACE=<logdir>: a torch.profiler trace of the first fit
    # round's steps (utils/profiling.py `trace`), as the JAX trainer's
    trace_dir = os.environ.get("TCNERF_TRACE")
    start_round = start_epoch // nt.eval_after_epochs
    for k in range(start_round, nt.n_epochs // nt.eval_after_epochs):
        batches = iter(prefetched_epochs(data_generator, nt.eval_after_epochs,
                                         device))
        with (trace(trace_dir) if trace_dir and k == start_round
              else contextlib.nullcontext()):
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                t_data = time.perf_counter() - t0
                state, metrics = T.nerf_train_step(state, *batch, generator)
                loss = float(metrics["loss"])
                history["steps"].append(dict(
                    step=state.step, loss=loss, data_s=t_data,
                    step_s=time.perf_counter() - t0))
        epoch = (k + 1) * nt.eval_after_epochs
        log.info("epoch %d: loss %.5f", epoch, history["steps"][-1]["loss"])
        validate(epoch, history["steps"][-1]["loss"])
        with open(progress_file, "w") as f:
            json.dump({"epoch": epoch}, f)
        ckpt.store(checkpoint, model, renderer_components(model))
        ckpt.store_meta(checkpoint, {
            "fusion": model.fusion,
            "fusion_use_dense": model.fusion_use_dense,
            "fusion_activation": model.fusion_activation,
            "field": model.field})
    return history


def init_weights(model: MVNeRFRenderer, cfg) -> None:
    """`<model_path>/model_final` where it is; else the ViT-B of
    `torch_weights_path` where that file is; else the seeded weights stay.
    In place, as tcnerf/train/train_nerf.py `_main` chooses."""
    checkpoint = os.path.join(cfg.nerf_training.model_path, "model_final")
    weights = cfg.get("torch_weights_path") or ""
    if ckpt.load(checkpoint, model, renderer_components(model)):
        log.info("Model loaded from %s.", checkpoint)
    elif os.path.exists(weights):
        from ..clip.import_torch import load_vit_b
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        load_vit_b(model.visual_features.vision_transformer.vit, sd)
        log.info("New model initialized from pretrained ViT weights")
    else:
        log.info("New model initialized (random ViT; no torch weights found)")


def _main(cfg, device: Optional[torch.device] = None,
          fusion: Optional[str] = None):
    """Data, model and optimizer from `cfg`, then `train_model`. `fusion`
    overrides `cfg.nerf_training.fusion`, as the JAX `_main`'s does.
    Returns (state, history)."""
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
    # a per-scene field (`valid_from_train`, the hash-grid configs)
    # validates on a held-out view of its training scene, which the
    # generator never draws; the pixel field on unseen scenes
    valid_from_train = cfg.get("valid_from_train", False)
    valid_data = load_validation(cfg, train_data if valid_from_train else
                                 load_dataset_nerf(n_persp, cfg.dataset.path
                                                   + "/valid"))
    seed = cfg.get("seed", 0)
    data_generator = MVNeRFDataGenerator(
        train_data, n_rays_train=nm.n_rays_train,
        batch_size=cfg.nerf_training.batch_size, n_views=nm.n_views,
        exclude_perspectives=((cfg.valid_perspective_tgt_idx,)
                              if valid_from_train else ()),
        shuffle=True, rng=seed)
    model = build_model(cfg, dev, fusion)
    nt = cfg.nerf_training
    state = T.create_train_state(model, T.make_nerf_optimizer(
        model, nerf_lr=nt.get("learning_rate", 1e-4),
        feature_lr=nt.get("feature_learning_rate", 1e-5),
        warmup_steps=nt.get("warmup_steps", 10000),
        scale_down_after=nt.get("scale_down_after", 450000)))
    init_weights(model, cfg)
    history = train_model(state, data_generator, cfg, valid_data, dev,
                          torch.Generator(device=dev).manual_seed(seed + 1))
    return state, history


def entry(argv: Optional[List[str]], config_name: str,
          fusion: Optional[str] = None):
    """The CLI: `--config-name=` and overrides from `argv` (default
    sys.argv), logging to stderr, then `_main`."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(message)s")
    name, overrides = parse_argv(sys.argv[1:] if argv is None else argv,
                                 config_name)
    return _main(load_config(overrides, name), fusion=fusion)


def main(argv: Optional[List[str]] = None):
    return entry(argv, "nerf_1_view")


if __name__ == "__main__":
    main()
