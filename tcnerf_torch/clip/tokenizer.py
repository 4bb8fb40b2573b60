"""CLIP byte-level BPE tokenizer (tcnerf/clip/tokenizer.py).

OpenAI CLIP's SimpleTokenizer semantics: byte->unicode mapping, word-final
`</w>` markers, greedy lowest-rank pair merging, a 77-token context framed
by SOT 49406 and EOT 49407, vocabulary size 49408.

The vocabulary is this package's own copy of the frozen BPE merges
(`bpe_frozen.txt.gz`, the same bytes as the JAX package's); `bpe_path` or
$TCNERF_CLIP_BPE selects an explicit merges file, such as OpenAI's
`bpe_simple_vocab_16e6.txt.gz`. A missing explicit file falls back, with a
warning, to the byte-level vocabulary without merges.

Pre-tokenisation splits as the JAX package's `\\p{L}` / `\\p{N}` pattern
does with the `regex` package (case-insensitive), without depending on it:
`_split` scans the text with `unicodedata` categories, whitespace is the
Unicode White_Space set (`regex`'s `\\s`), and the contractions match
case-insensitively as `regex` folds them (U+017F, the long s, is an 's').
Letters and digits are the categories of Python's `unicodedata`, plus the
letters and numbers `regex` knows from later Unicode versions, carried as a
table of code-point ranges (`unicode_ln.py`).
"""

from __future__ import annotations

import bisect
import functools
import gzip
import html
import os
import unicodedata
import warnings
from typing import List, Optional, Union

import numpy as np

from .unicode_ln import EXTRA_LETTERS, EXTRA_NUMBERS

VOCAB_SIZE = 49408
SOT_TOKEN = 49406
EOT_TOKEN = 49407
CONTEXT_LENGTH = 77

FROZEN_BPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bpe_frozen.txt.gz")

# Unicode White_Space: what `\s` matches in the `regex` package
_WHITESPACE = frozenset(
    "\t\n\v\f\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200b)))
_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve",
             "'m", "'ll", "'d")
_FOLD = {"\u017f": "s"}                # case-insensitive equals beyond lower()


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode mapping (GPT-2/CLIP standard)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(a, b) for a, b in zip(word, word[1:])}


def whitespace_clean(text: str) -> str:
    out, prev_space = [], False
    for ch in text:
        space = ch in _WHITESPACE
        if not (space and prev_space):
            out.append(" " if space else ch)
        prev_space = space
    return "".join(out).strip()


def basic_clean(text: str) -> str:
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text))


def _in_ranges(code: int, ranges) -> bool:
    i = bisect.bisect_right(ranges, (code, 0x10FFFF)) - 1
    return i >= 0 and ranges[i][0] <= code <= ranges[i][1]


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, ' ' whitespace, 'O' anything else: the
    `unicodedata` category, and `regex`'s newer letters and numbers from
    unicode_ln.py."""
    if ch in _WHITESPACE:
        return " "
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    code = ord(ch)
    if _in_ranges(code, EXTRA_LETTERS):
        return "L"
    if _in_ranges(code, EXTRA_NUMBERS):
        return "N"
    return "O"


def _literal_at(text: str, i: int) -> int:
    """Length of the first special token or contraction at text[i:], as
    a case-insensitive match; 0 if none."""
    for lit in _LITERALS:
        part = text[i:i + len(lit)]
        if len(part) == len(lit) and all(
                c == x or _FOLD.get(c) == x for c, x in zip(part, lit)):
            return len(lit)
    return 0


def _split(text: str) -> List[str]:
    """re.findall of the CLIP pattern
    `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
    [^\\s\\p{L}\\p{N}]+`: the first alternative that matches at a position
    wins; whitespace matches none and is skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        j = i + _literal_at(text, i)
        kind = _kind(text[i])
        if j == i and kind == "N":
            j = i + 1
        elif j == i and kind in "LO":
            j = i + 1
            while j < n and _kind(text[j]) == kind:
                j += 1
        if j == i:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        explicit = bpe_path or os.environ.get("TCNERF_CLIP_BPE")
        bpe_path = explicit or FROZEN_BPE
        self.is_frozen_vocab = not explicit and os.path.exists(FROZEN_BPE)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        base = list(self.byte_encoder.values())
        vocab = base + [v + "</w>" for v in base]
        merges = []
        self.is_fallback_vocab = not os.path.exists(bpe_path)
        if self.is_fallback_vocab:
            warnings.warn(
                "CLIP BPE merges file not found (bpe_path/$TCNERF_CLIP_BPE): "
                "using the byte-level fallback vocabulary. Token ids will NOT "
                "match OpenAI CLIP - supply bpe_simple_vocab_16e6.txt.gz for "
                "id-exact tokenization.", stacklevel=2)
        else:
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
            vocab.extend("".join(m) for m in merges)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.encoder["<|startoftext|>"] = SOT_TOKEN
        self.encoder["<|endoftext|>"] = EOT_TOKEN
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if first not in word[i:]:
                    new_word.extend(word[i:])
                    break
                j = word.index(first, i)
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        tokens = []
        for token in _split(whitespace_clean(basic_clean(text)).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts: Union[str, List[str]],
             context_length: int = CONTEXT_LENGTH, truncate: bool = False,
             tokenizer: Optional[SimpleTokenizer] = None) -> np.ndarray:
    """[n_texts, context_length] int32 token ids, SOT/EOT framed and zero
    padded; a longer text raises unless `truncate`."""
    if isinstance(texts, str):
        texts = [texts]
    tk = tokenizer or _default_tokenizer()
    all_tokens = [[SOT_TOKEN] + tk.encode(t) + [EOT_TOKEN] for t in texts]
    result = np.zeros((len(all_tokens), context_length), dtype=np.int32)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {texts[i]!r} is too long for "
                                   f"context length {context_length}")
            tokens = tokens[:context_length]
            tokens[-1] = EOT_TOKEN
        result[i, :len(tokens)] = tokens
    return result
