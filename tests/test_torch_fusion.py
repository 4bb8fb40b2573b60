"""tcnerf_torch fusion V0-V4 and the CLIP-fused renderer against the JAX
package on the CPU, plus the two port repairs: K1''s second-order
gradient and the trainer's `build_model` defaults.

Sizes are the JAX suite's (tests/test_language_backbone.py): 48x64
sources, n_features 256 (the decoders end in 256-channel convs), ViT dim
32 / 2 heads / 32^2 / hooks 1-4, CLIP layers (1, 1, 1, 1), width 8,
32^2, embed 32. V2 and the slice-gated V3/V4 (no `use_dense`) need a
1024-wide CLIP embedding (V2 compares it with a 2x2x256 pooled grid; the
slice takes the first 1024 entries), so those cases set clip_embed_dim
1024. Parameters fill the flax `init`'s tree (its shapes, from
`jax.eval_shape`: an eager init of the whole model costs a minute on the
CPU) with seeded normals at the init's scales, random biases and
batch-norm statistics, and go to the port through `from_flax`; the flax
side runs under `jax.jit`. Sampling draws are JAX's, captured with
`make_rng`. f32 bar: 1e-3 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnerf.models.renderer import MVNeRFRenderer as FlaxRenderer
from tcnerf.nn import fusion as jfusion
from tcnerf.train import train_nerf as jtrain_nerf
from tcnerf_torch.clip.preprocess import preprocess
from tcnerf_torch.core.rays import get_specific_rays
from tcnerf_torch.data.synthetic import camera_ring
from tcnerf_torch.models.renderer import MVNeRFRenderer
from tcnerf_torch.nn import fusion
from tcnerf_torch.ops.resmlp import resmlp_plain, resmlp_rows_diff
from tcnerf_torch.params import from_flax
from tcnerf_torch.train import config, train_nerf

H, W, S, R = 48, 64, 8, 16
TINY = dict(n_samples=S, n_features=256, near=0.3, far=1.3,
            original_image_size=(H, W), n_blocks=2, hidden_size=32,
            vit_size=(32, 32), vit_dim=32, vit_heads=2,
            vit_hooks=(1, 2, 3, 4), clip_layers=(1, 1, 1, 1), clip_width=8,
            clip_embed_dim=32, clip_image_size=32)
# (fusion, use_dense, activation); v3/v4 relu without dense is the stage-1
# default, elu with dense the language-backbone flavour
FUSION_CASES = [("v0", False, "relu"), ("v1", False, "relu"),
                ("v2", False, "relu"), ("v3", False, "relu"),
                ("v3", True, "elu"), ("v4", False, "relu"),
                ("v4", True, "elu")]
CLIP_CHANNELS = (32, 64, 128, 256)       # width 8: 4w .. 32w


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(got, want, rtol=1e-3):
    """|got - want| <= rtol * (|want| + max |want| * 1e-2)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * 1e-2 * float(np.abs(want).max()))


def _fill(shapes, rng, path=()):
    """Seeded values for a flax params tree of ShapeDtypeStructs: kernels
    normal / sqrt(fan_in), embeddings normal(0.02), norm scales near 1,
    biases and BN means near 0, BN variances in [0.5, 1.5]."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng, path + (k,))
            continue
        shape = v.shape
        if k == "kernel":
            fan_in = (shape[0] * shape[1] if len(shape) == 3
                      and path[-1] in ("attn_out", "out")
                      else int(np.prod(shape[:-1])) if len(shape) != 3
                      else shape[0])
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif k == "scale":
            a = rng.normal(1.0, 0.1, shape)
        else:                    # bias, mean, embeddings, cls_token
            a = rng.normal(0.0, 0.02 if "embed" in k else 0.1, shape)
        out[k] = np.asarray(a, np.float32)
    return out


def _init(module, *args, seed=0):
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(module.init, rngs, *args)["params"]
    return {"params": _fill(shapes, np.random.default_rng(seed))}


def _apply(module, variables, *args, jit=True, **kw):
    """module.apply at full f32 matmul precision, under jit or eager (whose
    compiled ops the tests share)."""
    fn = functools.partial(module.apply, **kw)
    with jax.default_matmul_precision("highest"):
        return (jax.jit(fn) if jit else fn)(variables, *args)


def _embed_dim(name, use_dense):
    return 1024 if name == "v2" or (name in ("v3", "v4") and not use_dense) \
        else 32


# ------------------------------------------------------------ the modules

@pytest.mark.parametrize("name,use_dense,activation", FUSION_CASES)
def test_fusion_module_matches_flax(name, use_dense, activation):
    """CombineCLIPVisualV0..V4 on random CLIP pyramids (the 32^2 tower's
    8x8 .. 1x1 levels) and a 24x32 visual map (16 channels): the fused
    image and V2's aux loss."""
    rng = np.random.default_rng(0)
    n, vis_c, e = 2, 16, _embed_dim(name, use_dense)
    clip = [rng.normal(size=(n, e))] + [
        rng.uniform(size=(n, s, s, c)) for s, c in zip((8, 4, 2, 1),
                                                       CLIP_CHANNELS)]
    clip = [np.asarray(c, np.float32) for c in clip]
    vis = rng.normal(size=(n, 24, 32, vis_c)).astype(np.float32)
    text = rng.normal(size=(n, e)).astype(np.float32)
    if name in ("v3", "v4"):
        jm = jfusion.__dict__[f"CombineCLIPVisual{name.upper()}"](
            use_dense=use_dense, activation=activation)
        pm = fusion.FUSIONS[name](CLIP_CHANNELS, vis_c, e,
                                  use_dense=use_dense, activation=activation)
    else:
        jm = jfusion.__dict__[f"CombineCLIPVisual{name.upper()}"]()
        pm = fusion.FUSIONS[name](CLIP_CHANNELS, vis_c)
    args = (tuple(jnp.asarray(c) for c in clip), jnp.asarray(vis),
            jnp.asarray(text))
    variables = _init(jm, *args)
    want, want_aux = _apply(jm, variables, *args)
    pm.load_state_dict(from_flax(variables["params"]), strict=True)
    with torch.no_grad():
        got, aux = pm(tuple(_t(c) for c in clip), _t(vis), _t(text))
    assert tuple(got.shape) == (n, 48, 64, 256)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4,
                               atol=1e-7)
    if name == "v2":
        assert float(want_aux) != 0.0


def test_categorical_crossentropy_matches_keras_semantics():
    """Normalised prediction, clipped to [eps, 1 - eps]; a negative sum
    clamps to eps."""
    rng = np.random.default_rng(1)
    y = rng.uniform(size=(3, 8)).astype(np.float32)
    for p in (rng.uniform(size=(3, 8)), -rng.uniform(size=(3, 8)),
              np.zeros((3, 8))):
        p = p.astype(np.float32)
        np.testing.assert_allclose(
            float(fusion._categorical_crossentropy(_t(y), _t(p))),
            float(jfusion._categorical_crossentropy(jnp.asarray(y),
                                                    jnp.asarray(p))),
            rtol=1e-6)


# --------------------------------------------------------- the renderer

def _scene(n_views, seed=0):
    """n_views sources on a ring around the target, rays through target
    pixels, source images from a numpy seed."""
    rng = np.random.default_rng(seed)
    cfgs = camera_ring(n_views + 1, height=H, width=W, azimuth_span=0.6)
    src_cfgs, tgt_cfg = cfgs[:-1], cfgs[-1]
    k4 = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in src_cfgs]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in src_cfgs], np.float32)
    src = rng.uniform(size=(1, n_views, H, W, 3)).astype(np.float32)
    ro, rd = get_specific_rays(rng.uniform(0, W - 1, R),
                               rng.uniform(0, H - 1, R), tgt_cfg["pose"],
                               tgt_cfg["intrinsics"].reshape(3, 3))
    return (ro[None].astype(np.float32), rd[None].astype(np.float32), src,
            k4[None], ext[None])


def _flax_model(n_views, **kw):
    fm = FlaxRenderer(n_views=n_views, **{**TINY, **kw})
    inputs = _scene(n_views)
    return fm, _init(fm, tuple(jnp.asarray(x) for x in inputs)), inputs


def _port(n_views, variables, **kw):
    m = MVNeRFRenderer(n_views=n_views, **{**TINY, **kw})
    m.load_state_dict(from_flax(variables["params"]), strict=True)
    return m.eval()


@pytest.mark.parametrize("name,use_dense,activation", FUSION_CASES)
def test_combine_features_matches_flax(name, use_dense, activation):
    """combine_features with the CLIP tower on the preprocessed sources and
    the ones text placeholder: the feature image and the aux loss."""
    kw = dict(fusion=name, fusion_use_dense=use_dense,
              fusion_activation=activation,
              clip_embed_dim=_embed_dim(name, use_dense))
    fm, variables, inputs = _flax_model(1, **kw)
    flat = inputs[2][0]
    want, want_aux = _apply(fm, variables, jnp.asarray(flat), jit=False,
                            method="combine_features")
    with torch.no_grad():
        got, aux = _port(1, variables, **kw).combine_features(_t(flat))
    assert tuple(got.shape) == (1, H, W, 256)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3,
                               atol=1e-7)


def test_combine_features_takes_given_clip_outputs_and_text():
    """Given CLIP outputs skip the tower; a given text embedding gates
    v4 (elu, dense) where the placeholder would not."""
    kw = dict(fusion="v4", fusion_use_dense=True, fusion_activation="elu")
    fm, variables, inputs = _flax_model(1, **kw)
    flat = inputs[2][0]
    rng = np.random.default_rng(2)
    text = rng.normal(size=(1, 32)).astype(np.float32)
    m = _port(1, variables, **kw)
    with torch.no_grad():
        clip_outputs = m.clip_visual(preprocess(_t(flat), 32))
        got, _ = m.combine_features(_t(flat), clip_outputs, _t(text))
        placeholder, _ = m.combine_features(_t(flat))
    want, _ = _apply(fm, variables, jnp.asarray(flat), None,
                     jnp.asarray(text), jit=False, method="combine_features")
    _close(got, want)
    assert not torch.allclose(got, placeholder)


def _draw(module, b, r, s):
    """The two `sampling` draws render_rays makes, in its order."""
    k_c = module.make_rng("sampling")
    k_f = module.make_rng("sampling")
    return (jax.random.uniform(k_c, (b, r, s)),
            jax.random.uniform(k_f, (b, r, s)))


@pytest.mark.parametrize("n_views,pallas_mlp", [(1, False), (3, False),
                                                (3, True)])
def test_v0_forward_matches_flax(n_views, pallas_mlp):
    """The whole v0 model (encode, CLIP tower, V0, hierarchical render)
    with explicit draws: 1 view, and the 3-view model whose mean view
    fusion sits between the chain halves (on the CPU `pallas_mlp` runs
    K1''s plain version). flax always runs pallas_mlp=False: its kernel
    has no interpret switch. f32: 1e-3."""
    fm, variables, inputs = _flax_model(n_views, fusion="v0")
    key = jax.random.PRNGKey(7)
    args = tuple(jnp.asarray(x) for x in inputs)
    want = _apply(fm, variables, args, rngs={"sampling": key})
    with jax.default_matmul_precision("highest"):
        u_c, u_f = fm.apply(variables, 1, R, S, method=_draw,
                            rngs={"sampling": key})
    m = _port(n_views, variables, fusion="v0", pallas_mlp=pallas_mlp)
    with torch.no_grad():
        got = m(tuple(_t(x) for x in inputs), u_coarse=_t(u_c),
                u_fine=_t(u_f))
    assert len(got) == len(want) == 5
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)


# ------------------------------------------------------------- repairs

def test_resmlp_rows_diff_second_order_matches_plain():
    """Reverse over reverse through K1' equals the plain chain's (f64,
    input 8, hidden 16, 2 blocks, 32 rows): d|dy/dx|^2 / d(first block's
    first kernel) for y = sum((K1'(x) + plain(x))^2) against
    y = sum((2 plain(x))^2), to 1e-10 relative."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape, scale=0.3):
        return torch.randn(shape, generator=g, dtype=torch.float64) * scale

    ws = [rand(8, 16), rand(16)]
    for _ in range(2):
        ws += [rand(16, 16), rand(16), rand(16, 16), rand(16)]
    ws = [w.requires_grad_() for w in ws]
    x = rand(32, 8, scale=1.0).requires_grad_()

    def second_order(f):
        y = f(x).pow(2).sum()
        gx, = torch.autograd.grad(y, x, create_graph=True)
        return torch.autograd.grad(gx.pow(2).sum(), ws[2])[0]

    got = second_order(lambda v: resmlp_rows_diff(v, ws, 2)
                       + resmlp_plain(v, ws, 2))
    want = second_order(lambda v: 2 * resmlp_plain(v, ws, 2))
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-10 * scale
    # first order is unchanged: no graph kept without create_graph
    y = resmlp_rows_diff(x, ws, 2).pow(2).sum()
    gx, = torch.autograd.grad(y, x)
    assert gx.grad_fn is None


class _Recorder(torch.nn.Module):
    """Stands in for a renderer class: records its constructor's knobs."""

    seen = []

    def __init__(self, **kw):
        super().__init__()
        self.seen.append({k: tuple(map(tuple, v)) if k == "hashgrid_bounds"
                          else tuple(v) if isinstance(v, list) else v
                          for k, v in kw.items()})


@pytest.mark.parametrize("overrides", [
    [], ["nerf_training.fusion=v4", "+nerf_model.fusion_use_dense=true",
         "+nerf_model.fusion_activation=elu", "+nerf_model.clip_width=8",
         "+nerf_model.pallas_mlp=true"]])
def test_build_model_takes_the_reference_knobs(monkeypatch, overrides):
    """The port's and the JAX trainer's `build_model` on one config pass
    the same knobs with the same values to their renderers: with no
    `nerf_training.fusion` (default v0, pallas_mlp False) and with the
    v4-elu language flavour."""
    cfg = config.load_config(overrides)
    if not overrides:
        del cfg.nerf_training["fusion"]
    _Recorder.seen = []
    monkeypatch.setattr(train_nerf, "MVNeRFRenderer", _Recorder)
    monkeypatch.setattr(jtrain_nerf, "MVNeRFRenderer", _Recorder)
    train_nerf.build_model(cfg, torch.device("cpu"))
    jtrain_nerf.build_model(cfg)
    got, want = _Recorder.seen
    assert got == want
    if not overrides:
        assert got["fusion"] == "v0" and got["pallas_mlp"] is False
