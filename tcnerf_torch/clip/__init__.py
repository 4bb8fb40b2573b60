"""CLIP towers, image preprocessing, tokenizer and weight loaders
(tcnerf/clip)."""

from .tokenizer import SimpleTokenizer, tokenize  # noqa: F401
