"""tcnerf_torch clip/ (towers, preprocess, tokenizer, loaders) and the
resampling layers they need, against the JAX package on the CPU.

Sizes are the JAX suite's (tests/test_language_backbone.py): RN50 tower
with layers (1, 1, 1, 1), width 8, embed 32, 32^2 images; a 2-layer,
32-wide text tower. Parameters come from the flax `init` (batch-norm
statistics perturbed, so no norm is the identity) through `from_flax`;
inputs from a numpy seed. f32 bars: 1e-5 for the resampling, 1e-3
relative (the repo's f32 bar) for the towers.
"""

import ast
import gzip
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnerf.clip import import_torch as jimport
from tcnerf.clip import model as jclip
from tcnerf.clip import tokenizer as jtok
from tcnerf.clip.preprocess import preprocess as jpreprocess
from tcnerf_torch.clip import import_torch, model, tokenizer
from tcnerf_torch.clip.preprocess import preprocess
from tcnerf_torch.nn.layers import avg_pool, max_pool, resize_cubic
from tcnerf_torch.params import from_flax, init_params

ROOT = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(got, want, rtol=1e-3):
    """|got - want| <= rtol * (|want| + max |want| * 1e-2)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * 1e-2 * float(np.abs(want).max()))


def _perturb(tree, rng):
    """Random batch-norm statistics and affine terms (flax inits them to the
    identity) in a numpy params tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        else:
            out[k] = np.asarray(v, np.float32)
    if "var" in out:
        c = out["var"].shape
        out.update(mean=rng.normal(0, 0.1, c), var=rng.uniform(0.5, 1.5, c),
                   scale=rng.normal(1, 0.1, c), bias=rng.normal(0, 0.1, c))
        out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    return out


def _init(module, *args, seed=0):
    with jax.default_matmul_precision("highest"):
        params = module.init(jax.random.PRNGKey(seed), *args)["params"]
    return _perturb(jax.device_get(params), np.random.default_rng(seed))


def _apply(module, params, *args):
    with jax.default_matmul_precision("highest"):
        return module.apply({"params": params}, *args)


def _port(cls, params, *args, **kw):
    m = cls(*args, **kw)
    m.load_state_dict(from_flax(params), strict=True)
    return m.eval()


# ------------------------------------------------------------ resampling

@pytest.mark.parametrize("shape,size", [((2, 48, 64, 3), (85, 64)),
                                        ((2, 48, 64, 3), (29, 22)),
                                        ((1, 16, 12, 5), (40, 7)),
                                        ((1, 480, 640, 3), (298, 224))])
def test_resize_cubic_matches_jax(shape, size):
    """jax.image.resize(..., "cubic"): growing, shrinking (antialiased) and
    both at once, at 1e-5. F.interpolate's bicubic would be a = -0.75, no
    antialias, no edge renormalisation."""
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (shape[0], *size, shape[3]),
                            "cubic")
    got = resize_cubic(_t(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [(2, 2), (3, 4)])
def test_pools_match_flax(window):
    import flax.linen as nn
    x = np.random.default_rng(1).normal(size=(2, 9, 11, 3)).astype(np.float32)
    for port, ref in ((avg_pool, nn.avg_pool), (max_pool, nn.max_pool)):
        want = ref(jnp.asarray(x), window, strides=window, padding="VALID")
        np.testing.assert_array_equal(port(_t(x), window, window).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("hw", [(48, 64), (64, 48)])
def test_preprocess_matches_jax(hw):
    """The resize-axis quirk (48x64 resizes to 42x32 and 64x48 to 32x42,
    at to_size 32), the centre crop and the standardisation, at 1e-5."""
    x = np.random.default_rng(2).uniform(size=(2, *hw, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jpreprocess(jnp.asarray(x), 32)
    got = preprocess(_t(x), 32)
    assert tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------- image tower

def test_frozen_batch_norm_matches_flax():
    x = np.random.default_rng(3).normal(size=(2, 4, 5, 8)).astype(np.float32)
    params = _init(jclip.FrozenBatchNorm(), jnp.asarray(x))
    got = _port(model.FrozenBatchNorm, params, 8)(_t(x))
    _close(got.detach(), _apply(jclip.FrozenBatchNorm(), params,
                                jnp.asarray(x)))


@pytest.mark.parametrize("in_features,planes,stride", [(16, 4, 1), (8, 4, 1),
                                                       (8, 4, 2)])
def test_bottleneck_matches_flax(in_features, planes, stride):
    """Identity skip, 1x1-projected skip, and the anti-aliased stride 2 on
    an odd size (7x9: the average pool floors)."""
    x = np.random.default_rng(4).normal(
        size=(2, 7, 9, in_features)).astype(np.float32)
    jm = jclip.Bottleneck(planes, stride)
    params = _init(jm, jnp.asarray(x))
    got = _port(model.Bottleneck, params, in_features, planes, stride)(_t(x))
    _close(got.detach(), _apply(jm, params, jnp.asarray(x)))


def test_attention_pool_matches_flax():
    x = np.random.default_rng(5).normal(size=(2, 2, 3, 64)).astype(np.float32)
    jm = jclip.AttentionPool2d(num_heads=4, output_dim=32)
    params = _init(jm, jnp.asarray(x))
    got = _port(model.AttentionPool2d, params, 6, 64, 4, 32)(_t(x))
    assert tuple(got.shape) == (2, 32)
    _close(got.detach(), _apply(jm, params, jnp.asarray(x)))


@pytest.mark.parametrize("size", [32, 40])
def test_modified_resnet_matches_flax(size):
    """CLIPVisualEncoder's 5-tuple (embedding, l1..l4)."""
    x = np.random.default_rng(6).normal(
        size=(2, size, size, 3)).astype(np.float32)
    kw = dict(layers=(1, 1, 1, 1), width=8, output_dim=32, heads=4)
    jm = jclip.CLIPVisualEncoder(**kw)
    params = _init(jm, jnp.asarray(x))
    pm = _port(model.CLIPVisualEncoder, params, image_size=size, **kw)
    with torch.no_grad():
        got = pm(_t(x))
    want = _apply(jm, params, jnp.asarray(x))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_text_transformer_matches_flax():
    """Causal blocks, QuickGELU, flax LayerNorm eps 1e-6, the EOT feature."""
    tokens = tokenizer.tokenize(["a red ball", "pick up the green cube!"])
    kw = dict(width=32, heads=4, n_layers=2, output_dim=16)
    jm = jclip.CLIPTextualEncoder(**kw)
    params = _init(jm, jnp.asarray(tokens))
    pm = _port(model.CLIPTextualEncoder, params, **kw)
    with torch.no_grad():
        got = pm(torch.as_tensor(tokens))
    assert tuple(got.shape) == (2, 16)
    _close(got, _apply(jm, params, jnp.asarray(tokens)))


def test_init_params_sets_the_towers_leaves():
    """Seeded init: BN variances 1 (not 0), means 0; the CLIP initialisers'
    scales; every parameter finite."""
    torch.manual_seed(0)
    v = model.CLIPVisualEncoder(layers=(1, 1, 1, 1), width=8, output_dim=32,
                                heads=4, image_size=32)
    t = model.CLIPTextualEncoder(width=32, heads=4, n_layers=1, output_dim=16)
    for m in (v, t):
        init_params(m, torch.Generator().manual_seed(0))
    sd = {**v.state_dict(), **t.state_dict()}
    for name, p in sd.items():
        assert torch.isfinite(p).all(), name
        if name.endswith(".var") or name.endswith(".scale"):
            assert torch.equal(p, torch.ones_like(p)), name
        if name.endswith(".mean"):
            assert torch.equal(p, torch.zeros_like(p)), name
    stds = {"text.token_embedding.weight": 0.02,
            "text.positional_embedding": 0.01,
            "visual.attnpool.positional_embedding": 256 ** -0.5,
            "text.text_projection": 32 ** -0.5}
    for name, std in stds.items():
        assert abs(float(sd[name].std()) / std - 1) < 0.2, name


# -------------------------------------------------------------- tokenizer

STRINGS = ["a photo of a cat", "a photo of a dog", "hello world",
           "café ½ 東京", "It's   the robot's ARM!!", "naïve—résumé… x²",
           "<|startoftext|>pick<|endoftext|>", "'ſ don't 1234abc", "",
           "tab\tand\nnew line \x1c　end", "emoji 🤖 ok"]


def test_tokenize_matches_jax():
    """Ids equal to the JAX tokenizer's (which has `regex` here) on the
    golden strings plus non-ASCII ones: [N, 77], SOT 49406, EOT 49407."""
    assert jtok._HAS_REGEX
    got = tokenizer.tokenize(STRINGS)
    want = jtok.tokenize(STRINGS)
    assert got.shape == (len(STRINGS), 77) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == tokenizer.SOT_TOKEN).all()
    assert tokenizer.VOCAB_SIZE == jtok.VOCAB_SIZE == 49408
    assert tokenizer.SimpleTokenizer().is_frozen_vocab


def test_split_matches_regex_pattern():
    """The scanner against `regex.findall` of the JAX pattern on seeded
    random strings (letters, digits, marks, symbols, Unicode spaces,
    contractions, special tokens)."""
    import regex
    rng = np.random.default_rng(7)
    pool = [chr(c) for c in (list(range(0x20, 0x250)) + list(range(0x370, 0x3ff))
                             + list(range(0x2000, 0x2070))
                             + [0x3000, 0x4e00, 0x6771, 0x17f, 0x1c, 0x85,
                                0x1f916, 0x300, 0x660])]
    pool += ["'s", "'ll", "'d", " ", "<|endoftext|>"]
    for _ in range(500):
        s = "".join(pool[i] for i in rng.integers(0, len(pool),
                                                  rng.integers(0, 24)))
        text = jtok.whitespace_clean(jtok.basic_clean(s)).lower()
        assert tokenizer.whitespace_clean(tokenizer.basic_clean(s)).lower() \
            == text, repr(s)
        assert tokenizer._split(text) == regex.findall(jtok._PATTERN, text), \
            repr(s)
    # every code point that regex's \p{L} / \p{N} or unicodedata calls a
    # letter or a number, each between an ASCII letter and a digit
    import unicodedata
    letter, number = regex.compile(r"\p{L}"), regex.compile(r"\p{N}")
    points = [chr(c) for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF
              and (letter.match(chr(c)) or number.match(chr(c))
                   or unicodedata.category(chr(c))[0] in "LN")]
    assert len(points) > 130000
    for ch in points:
        want = "L" if letter.match(ch) else "N"
        assert tokenizer._kind(ch) == want, hex(ord(ch))
    text = " ".join(f"a{ch}1" for ch in points)
    assert tokenizer._split(text) == regex.findall(jtok._PATTERN, text)


def test_tokenize_newer_unicode_letter_matches_jax():
    """U+0C5C (a Telugu letter newer than Python 3.12's Unicode 15.0) is a
    letter, as the JAX tokenizer with `regex` has it: "a\u0c5cb" is one
    word."""
    import regex  # noqa: F401  (the JAX tokenizer's pattern needs it)
    want = jtok.tokenize("a\u0c5cb")
    got = tokenizer.tokenize("a\u0c5cb")
    np.testing.assert_array_equal(got, want)
    assert list(got[0][:6]) == [49406, 64, 156, 109, 250, 321]


def test_tokenizer_imports_no_regex_and_has_its_own_vocab():
    src = (ROOT / "tcnerf_torch/clip/tokenizer.py").read_text()
    roots = {(a.name if isinstance(n, ast.Import) else n.module).split(".")[0]
             for n in ast.walk(ast.parse(src))
             if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in (n.names if isinstance(n, ast.Import) else [n])}
    assert "regex" not in roots
    assert Path(tokenizer.FROZEN_BPE).parent == ROOT / "tcnerf_torch/clip"
    assert (Path(tokenizer.FROZEN_BPE).read_bytes()
            == Path(jtok.FROZEN_BPE).read_bytes())


def test_bpe_merges_file_matches_jax(tmp_path):
    """An explicit merges file: greedy lowest-rank merging as the JAX
    tokenizer does it (tests/test_tokenizer_golden.py's merges)."""
    merges = [("l", "o"), ("lo", "w</w>"), ("e", "r</w>"), ("h", "e"),
              ("l", "l"), ("he", "ll"), ("a", "b</w>"), ("c", "ab</w>")]
    path = str(tmp_path / "merges.txt.gz")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + [f"{a} {b}" for a, b in merges])
                + "\n")
    got, want = tokenizer.SimpleTokenizer(path), jtok.SimpleTokenizer(path)
    for word in ("low", "lower", "hello", "cab", "ba"):
        assert got.bpe(word) == want.bpe(word)
    text = "hello lower cab ba!"
    assert got.encode(text) == want.encode(text)
    assert got.decode(got.encode(text)) == want.decode(want.encode(text))


# ----------------------------------------------------------------- loaders

def _rn50_state(rng, layers, w, heads, grid, out_dim):
    """A synthetic OpenAI-layout RN50 `visual.*` state dict."""
    sd = {}

    def bn(p, c):
        sd.update({f"{p}.weight": rng.normal(1, 0.1, c),
                   f"{p}.bias": rng.normal(0, 0.1, c),
                   f"{p}.running_mean": rng.normal(0, 0.1, c),
                   f"{p}.running_var": rng.uniform(0.5, 1.5, c)})

    for i, (ci, co) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)),
                                 start=1):
        sd[f"visual.conv{i}.weight"] = rng.normal(size=(co, ci, 3, 3))
        bn(f"visual.bn{i}", co)
    inplanes = w
    for s, n in enumerate(layers):
        planes = w * 2 ** s
        for i in range(n):
            p = f"visual.layer{s + 1}.{i}"
            sd[f"{p}.conv1.weight"] = rng.normal(size=(planes, inplanes, 1, 1))
            sd[f"{p}.conv2.weight"] = rng.normal(size=(planes, planes, 3, 3))
            sd[f"{p}.conv3.weight"] = rng.normal(size=(4 * planes, planes, 1, 1))
            for j, c in ((1, planes), (2, planes), (3, 4 * planes)):
                bn(f"{p}.bn{j}", c)
            if i == 0:
                sd[f"{p}.downsample.0.weight"] = rng.normal(
                    size=(4 * planes, inplanes, 1, 1))
                bn(f"{p}.downsample.1", 4 * planes)
            inplanes = 4 * planes
    sd["visual.attnpool.positional_embedding"] = rng.normal(
        size=(grid + 1, inplanes))
    for name, o in (("q", inplanes), ("k", inplanes), ("v", inplanes),
                    ("c", out_dim)):
        sd[f"visual.attnpool.{name}_proj.weight"] = rng.normal(
            size=(o, inplanes))
        sd[f"visual.attnpool.{name}_proj.bias"] = rng.normal(size=(o,))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _text_state(rng, width, n_layers, out_dim):
    sd = {"token_embedding.weight": rng.normal(size=(49408, width)),
          "positional_embedding": rng.normal(size=(77, width)),
          "text_projection": rng.normal(size=(width, out_dim)),
          "ln_final.weight": rng.normal(size=width),
          "ln_final.bias": rng.normal(size=width)}
    for i in range(n_layers):
        p = f"transformer.resblocks.{i}"
        shapes = {"ln_1.weight": (width,), "ln_1.bias": (width,),
                  "ln_2.weight": (width,), "ln_2.bias": (width,),
                  "attn.in_proj_weight": (3 * width, width),
                  "attn.in_proj_bias": (3 * width,),
                  "attn.out_proj.weight": (width, width),
                  "attn.out_proj.bias": (width,),
                  "mlp.c_fc.weight": (4 * width, width),
                  "mlp.c_fc.bias": (4 * width,),
                  "mlp.c_proj.weight": (width, 4 * width),
                  "mlp.c_proj.bias": (width,)}
        sd.update({f"{p}.{k}": rng.normal(size=s) for k, s in shapes.items()})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _vit_state(rng, dim, n_blocks, n_tokens):
    sd = {"cls_token": rng.normal(size=(1, 1, dim)),
          "pos_embed": rng.normal(size=(1, n_tokens, dim)),
          "patch_embed.proj.weight": rng.normal(size=(dim, 3, 16, 16)),
          "patch_embed.proj.bias": rng.normal(size=dim)}
    for i in range(n_blocks):
        shapes = {"norm1.weight": (dim,), "norm1.bias": (dim,),
                  "norm2.weight": (dim,), "norm2.bias": (dim,),
                  "attn.qkv.weight": (3 * dim, dim), "attn.qkv.bias": (3 * dim,),
                  "attn.proj.weight": (dim, dim), "attn.proj.bias": (dim,),
                  "mlp.fc1.weight": (4 * dim, dim), "mlp.fc1.bias": (4 * dim,),
                  "mlp.fc2.weight": (dim, 4 * dim), "mlp.fc2.bias": (dim,)}
        sd.update({f"blocks.{i}.{k}": rng.normal(size=s)
                   for k, s in shapes.items()})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _same_state(module, want):
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_clip_rn50_visual_loader_matches_jax_import():
    """The port's loader (from numpy or torch tensors) gives the tower the
    state that import_clip_rn50_visual + from_flax gives, key for key and
    bit for bit."""
    layers, heads = (2, 1, 1, 1), 4
    sd = _rn50_state(np.random.default_rng(8), layers, 8, heads, 1, 32)
    want = from_flax(jimport.import_clip_rn50_visual(sd, layers, heads))
    m = model.CLIPVisualEncoder(layers, 8, 32, heads, image_size=32)
    import_torch.load_clip_rn50_visual(m, {k: torch.as_tensor(v)
                                           for k, v in sd.items()})
    _same_state(m, want)


def test_clip_text_loader_matches_jax_import():
    sd = _text_state(np.random.default_rng(9), 16, 2, 8)
    want = from_flax(jimport.import_clip_text(sd, n_layers=2, heads=4,
                                              width=16))
    m = model.CLIPTextualEncoder(width=16, heads=4, n_layers=2, output_dim=8)
    import_torch.load_clip_text(m, sd)
    _same_state(m, want)


def test_vit_b_loader_matches_jax_import():
    from tcnerf_torch.nn.vit import VisionTransformer
    sd = _vit_state(np.random.default_rng(10), 24, 2, 5)
    want = from_flax(jimport.import_vit_b(sd, n_blocks=2, n_heads=2))
    m = VisionTransformer((32, 32), 16, 24, 4, 2, hooks=(1, 2))
    import_torch.load_vit_b(m, sd)
    _same_state(m, want)
