"""Loaders of published PyTorch weights into the port's modules
(tcnerf/clip/import_torch.py).

  * OpenAI CLIP RN50 (`visual.*` keys, `attnpool.{q,k,v,c}_proj`) into
    `CLIPVisualEncoder`;
  * the OpenAI CLIP text transformer (`transformer.resblocks.N.*`, the
    attention's packed `in_proj` split into q/k/v) into
    `CLIPTextualEncoder`;
  * a timm/DPT ViT-B (`blocks.N.*`, packed `attn.qkv`) into
    `VisionTransformer` (`VisualFeatures.vision_transformer.vit`).

The port's layers keep PyTorch's layouts (Linear [out, in], Conv OIHW), and
its q/k/v/out projections index heads as h * head_dim + d, as the source
networks do, so weights load as they are; only names change, BatchNorm
statistics become `FrozenBatchNorm`'s `mean`/`var` and LayerNorm weights
`scale`. Each `load_*` maps a source state dict (tensors or numpy
arrays, e.g. from `torch.load`) onto the module's names and loads it
strictly.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x.detach().cpu() if hasattr(x, "detach")
                                      else x, dtype=np.float32))


def _bn(sd: Mapping, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.scale": _t(sd[f"{src}.weight"]),
            f"{dst}.bias": _t(sd[f"{src}.bias"]),
            f"{dst}.mean": _t(sd[f"{src}.running_mean"]),
            f"{dst}.var": _t(sd[f"{src}.running_var"])}


def _ln(sd: Mapping, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.scale": _t(sd[f"{src}.weight"]),
            f"{dst}.bias": _t(sd[f"{src}.bias"])}


def _linear(sd: Mapping, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.weight": _t(sd[f"{src}.weight"]),
            f"{dst}.bias": _t(sd[f"{src}.bias"])}


def _qkv(weight, bias, dst: str) -> Dict[str, torch.Tensor]:
    """A packed [3*D, D] projection split into q, k and v."""
    out = {}
    for name, w, b in zip("qkv", _t(weight).chunk(3), _t(bias).chunk(3)):
        out[f"{dst}.{name}.weight"] = w.contiguous()
        out[f"{dst}.{name}.bias"] = b.contiguous()
    return out


def load_clip_rn50_visual(module: torch.nn.Module, sd: Mapping) -> None:
    """OpenAI CLIP RN50 `visual.*` weights into a `CLIPVisualEncoder`."""
    layers = [len(stage) for stage in module.visual.stages]
    out = {}
    for i in (1, 2, 3):
        out[f"visual.stem_conv{i}.weight"] = _t(sd[f"visual.conv{i}.weight"])
        out.update(_bn(sd, f"visual.bn{i}", f"visual.stem_bn{i}"))
    for stage, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            src = f"visual.layer{stage + 1}.{i}"
            dst = f"visual.layer{stage + 1}_{i}"
            for j in (1, 2, 3):
                out[f"{dst}.conv{j}.weight"] = _t(sd[f"{src}.conv{j}.weight"])
                out.update(_bn(sd, f"{src}.bn{j}", f"{dst}.bn{j}"))
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample_conv.weight"] = _t(
                    sd[f"{src}.downsample.0.weight"])
                out.update(_bn(sd, f"{src}.downsample.1",
                               f"{dst}.downsample_bn"))
    pool = "visual.attnpool"
    out[f"{pool}.positional_embedding"] = _t(sd[f"{pool}.positional_embedding"])
    for src, dst in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                     ("c_proj", "out")):
        out.update(_linear(sd, f"{pool}.{src}", f"{pool}.{dst}"))
    module.load_state_dict(out, strict=True)


def load_clip_text(module: torch.nn.Module, sd: Mapping) -> None:
    """OpenAI CLIP text-transformer weights into a `CLIPTextualEncoder`."""
    out = {"text.token_embedding.weight": _t(sd["token_embedding.weight"]),
           "text.positional_embedding": _t(sd["positional_embedding"]),
           "text.text_projection": _t(sd["text_projection"]),
           **_ln(sd, "ln_final", "text.ln_final")}
    for i in range(len(module.text.blocks)):
        src, dst = f"transformer.resblocks.{i}", f"text.block_{i}"
        out.update(_ln(sd, f"{src}.ln_1", f"{dst}.ln_1"))
        out.update(_ln(sd, f"{src}.ln_2", f"{dst}.ln_2"))
        out.update(_qkv(sd[f"{src}.attn.in_proj_weight"],
                        sd[f"{src}.attn.in_proj_bias"], dst))
        out.update(_linear(sd, f"{src}.attn.out_proj", f"{dst}.attn_out"))
        out.update(_linear(sd, f"{src}.mlp.c_fc", f"{dst}.mlp_fc"))
        out.update(_linear(sd, f"{src}.mlp.c_proj", f"{dst}.mlp_proj"))
    module.load_state_dict(out, strict=True)


def load_vit_b(module: torch.nn.Module, sd: Mapping) -> None:
    """timm/DPT ViT-B weights (`blocks.N.*`) into a `VisionTransformer`."""
    out = {"cls_token": _t(sd["cls_token"]).reshape(1, 1, -1),
           "pos_embedding": _t(sd["pos_embed"]),
           **_linear(sd, "patch_embed.proj", "patch_embed.proj")}
    for i in range(len(module.blocks)):
        src, dst = f"blocks.{i}", f"block_{i}"
        out.update(_ln(sd, f"{src}.norm1", f"{dst}.norm_1"))
        out.update(_ln(sd, f"{src}.norm2", f"{dst}.norm_2"))
        out.update(_qkv(sd[f"{src}.attn.qkv.weight"],
                        sd[f"{src}.attn.qkv.bias"], dst))
        out.update(_linear(sd, f"{src}.attn.proj", f"{dst}.attn_out"))
        out.update(_linear(sd, f"{src}.mlp.fc1", f"{dst}.mlp_0"))
        out.update(_linear(sd, f"{src}.mlp.fc2", f"{dst}.mlp_1"))
    module.load_state_dict(out, strict=True)
