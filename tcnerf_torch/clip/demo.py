"""CLIP demo: image / text similarity of the frozen towers
(tcnerf/clip/demo.py).

    python -m tcnerf_torch.clip.demo [--weights RN50.pt] [--size 224] \\
        [--device cpu]

encodes three synthetic tabletop scenes and three prompts with the RN50
image tower and the text tower and prints, per image, the softmax of 100 x
the cosine similarities. Without `--weights` (OpenAI's RN50 `torch.save`
archive) the towers keep seeded random weights, and the demo says that
their probabilities mean nothing. Runs on the card unless `--device`
names another.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

TEXTS = ["a red ball on a table", "a green ball on a table",
         "an empty checkered table"]


def demo_images(size: int) -> np.ndarray:
    """[3, size, size, 3] float32 in [0, 1]: scenes 0, 1, 2 with two
    spheres each, seen by the first camera of a one-camera ring."""
    from ..data.synthetic import SyntheticScene, camera_ring

    cfg = camera_ring(1, height=size, width=size)[0]
    images = [SyntheticScene.random(seed, n_spheres=2).render(
        cfg["pose"], cfg["intrinsics"].reshape(3, 3), size, size)[..., :3]
        / 255.0 for seed in (0, 1, 2)]
    return np.stack(images).astype(np.float32)


def similarity_logits(visual, textual, images: torch.Tensor,
                      tokens: torch.Tensor, size: int) -> torch.Tensor:
    """[n_images, n_texts]: 100 x the cosine similarity of each image's
    embedding (the image tower's first output, on `preprocess(images,
    size)`) and each text's."""
    from .preprocess import preprocess

    image_emb = visual(preprocess(images, size))[0]
    text_emb = textual(tokens)
    image_emb = image_emb / torch.linalg.norm(image_emb, dim=-1, keepdim=True)
    text_emb = text_emb / torch.linalg.norm(text_emb, dim=-1, keepdim=True)
    return 100.0 * image_emb @ text_emb.T


def run(size: int = 224, weights: Optional[str] = None,
        device=None) -> np.ndarray:
    """The demo's [3, 3] label probabilities (rows: images, columns:
    TEXTS) from the full-size RN50 and text towers on `device`."""
    from ..device import resolve_device
    from ..params import init_params
    from .model import CLIPTextualEncoder, CLIPVisualEncoder
    from .tokenizer import tokenize

    dev = resolve_device(device)
    visual = CLIPVisualEncoder(image_size=size).to(dev).eval()
    textual = CLIPTextualEncoder().to(dev).eval()
    if weights:
        from .import_torch import load_clip_rn50_visual, load_clip_text
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        load_clip_rn50_visual(visual, sd)
        load_clip_text(textual, sd)
        print("loaded OpenAI CLIP RN50 weights")
    else:
        for seed, tower in enumerate((visual, textual)):
            init_params(tower, torch.Generator(device=dev).manual_seed(seed))
        print("no weights given: random towers (the probabilities are not "
              "meaningful)")
    images = torch.as_tensor(demo_images(size), device=dev)
    tokens = torch.as_tensor(tokenize(TEXTS).astype(np.int64), device=dev)
    with torch.no_grad():
        logits = similarity_logits(visual, textual, images, tokens, size)
    return torch.softmax(logits, dim=-1).cpu().numpy()


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", default=None,
                        help="OpenAI CLIP RN50 torch checkpoint (optional)")
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    probs = run(args.size, args.weights, args.device)
    print("label probabilities per image:")
    for i, row in enumerate(probs):
        print(f"  image {i}: " + "  ".join(
            f"{t!r}: {p:.3f}" for t, p in zip(TEXTS, row)))
    return probs


if __name__ == "__main__":
    main()
