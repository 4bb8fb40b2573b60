"""tcnerf_torch nn/ modules against the flax modules: params from flax
`init`, converted by `tcnerf_torch.params.from_flax`, inputs from numpy.

Tolerance: f32 paths at 1e-3 relative (the JAX suite's f32 bar) with an
absolute floor of 1e-4 x max|ref| for values that cancel to near zero;
both sides run in full fp32 (Precision.HIGHEST / TF32 off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnerf.nn import blocks as jblocks
from tcnerf.nn import conv as jconv
from tcnerf.nn import mlp as jmlp
from tcnerf.nn import norm as jnorm
from tcnerf.nn import vit as jvit
from tcnerf_torch.nn import blocks, conv, layers, mlp, norm, vit
from tcnerf_torch.params import from_flax, init_params


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(got, want, rtol=1e-3):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-4 * float(np.abs(want).max()))


def _port(module, flax_params):
    module.load_state_dict(from_flax(jax.device_get(flax_params)), strict=True)
    return module.eval()


def _init_apply(fmod, *inputs, method=None):
    with jax.default_matmul_precision("highest"):
        params = fmod.init(jax.random.PRNGKey(0), *inputs)["params"]
        out = fmod.apply({"params": params}, *inputs, method=method)
    return params, out


def test_batch_stat_norm():
    x = np.random.default_rng(0).normal(2.0, 3.0, (2, 5, 6, 4)).astype(np.float32)
    params, want = _init_apply(jnorm.BatchStatNorm(), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda p: p + 0.5, params)
    want = jnorm.BatchStatNorm().apply({"params": params}, jnp.asarray(x))
    got = _port(norm.BatchStatNorm(4), params)(_t(x))
    _close(got, want)


@pytest.mark.parametrize("hw,k,s", [((15, 22), 7, 2), ((7, 7), 3, 2),
                                    ((9, 10), 3, 1)])
def test_conv_same_padding(hw, k, s):
    """flax SAME at stride 2 pads the odd row/column at the bottom/right."""
    import flax.linen as fnn
    x = np.random.default_rng(1).normal(size=(2,) + hw + (3,)).astype(np.float32)
    params, want = _init_apply(fnn.Conv(5, (k, k), strides=(s, s),
                                        padding="SAME"), jnp.asarray(x))
    got = _port(layers.Conv(3, 5, k, strides=s), params)(_t(x))
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_flip(k):
    """flax ConvTranspose (transpose_kernel=False, SAME) needs a spatial
    flip of the kernel as well as the permute."""
    import flax.linen as fnn

    class Deconv(fnn.Module):                  # named like the DPT layers
        @fnn.compact
        def __call__(self, x):
            return fnn.ConvTranspose(4, (k, k), strides=(k, k),
                                     name="pp_deconv")(x)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pp_deconv = layers.ConvTranspose(3, 4, k, k)

        def forward(self, x):
            return self.pp_deconv(x)

    x = np.random.default_rng(2).normal(size=(2, 3, 5, 3)).astype(np.float32)
    params, want = _init_apply(Deconv(), jnp.asarray(x))
    _close(_port(Port(), params)(_t(x)), want)


@pytest.mark.parametrize("src,dst", [((32, 40), (16, 16)), ((7, 9), (14, 18)),
                                     ((24, 32), (11, 13))])
def test_resize_matches_jax_image_resize(src, dst):
    """Down (antialiased) and up (half-pixel) sampling, edges included."""
    x = np.random.default_rng(3).normal(size=(2,) + src + (3,)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,), "bilinear")
    _close(layers.resize_bilinear(_t(x), dst), want, rtol=1e-4)


def test_resnet_block_and_readouts():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    params, want = _init_apply(jblocks.ResNetMLPBlock(12, 16, transform_shortcut=True),
                               jnp.asarray(x))
    _close(_port(blocks.ResNetMLPBlock(16, 12, 16, transform_shortcut=True),
                 params)(_t(x)), want)
    params, (wc, wd) = _init_apply(jblocks.RenderReadout(), jnp.asarray(x))
    gc, gd = _port(blocks.RenderReadout(16), params)(_t(x))
    _close(gc, wc)
    _close(gd, wd)
    params, want = _init_apply(jblocks.Readout(5), jnp.asarray(x))
    _close(_port(blocks.Readout(16, 5), params)(_t(x)), want)


@pytest.mark.parametrize("n_views,projected", [(2, False), (1, True)])
def test_mv_embedding(n_views, projected):
    """Mean view fusion after n_blocks//2 blocks; the complete_output list;
    the SliceableDense head/tail split."""
    rng = np.random.default_rng(5)
    b, r, s, c = 2 * n_views, 3, 4, 7
    pos = rng.normal(size=(b, r, s, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, r, s, 3)).astype(np.float32)
    feats = rng.normal(size=(b, r, s, c)).astype(np.float32)
    fm = jmlp.MVResNetMLPEmbedding(n_blocks=3, hidden_size=32, n_views=n_views,
                                   embed_direction_vector=True,
                                   complete_output=True, n_input_features=c)
    with jax.default_matmul_precision("highest"):
        params = fm.init(jax.random.PRNGKey(0), pos, dirs, feats)["params"]
        if projected:
            img = jnp.asarray(feats)
            proj = fm.apply({"params": params}, img, method="project_image")
            want = fm.apply({"params": params}, pos, dirs, proj, True)
        else:
            want = fm.apply({"params": params}, pos, dirs, feats)
    tm = _port(mlp.MVResNetMLPEmbedding(c, n_blocks=3, hidden_size=32,
                                        n_views=n_views,
                                        embed_direction_vector=True,
                                        complete_output=True), params)
    if projected:
        tproj = tm.project_image(_t(feats))
        _close(tproj, proj)
        got = tm(_t(pos), _t(dirs), tproj, True)
    else:
        got = tm(_t(pos), _t(dirs), _t(feats))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def test_conv_encoder():
    x = np.random.default_rng(6).uniform(size=(2, 15, 21, 3)).astype(np.float32)
    params, want = _init_apply(jconv.ConvolutionalEncoder(16), jnp.asarray(x))
    got = _port(conv.ConvolutionalEncoder(16), params)(_t(x))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_transformer_block():
    x = np.random.default_rng(7).normal(size=(2, 5, 32)).astype(np.float32)
    params, want = _init_apply(jvit.TransformerBlock(num_heads=2, embed_dim=32),
                               jnp.asarray(x))
    got = _port(vit.TransformerBlock(2, 32), params)(_t(x))
    _close(got, want)


def test_visual_features():
    """ViT (hooks 1-4) + DPT decoder + conv path, 16x24 images."""
    x = np.random.default_rng(8).uniform(size=(2, 16, 24, 3)).astype(np.float32)
    kw = dict(n_features=16, original_image_size=(16, 24), vit_size=(32, 32),
              patch_size=16, embed_dim=32, num_heads=2, hooks=(1, 2, 3, 4))
    params, want = _init_apply(jvit.VisualFeatures(**kw), jnp.asarray(x))
    got = _port(vit.VisualFeatures(**kw), params)(_t(x))
    assert tuple(got.shape) == want.shape == (2, 8, 12, 16)
    _close(got, want)


def test_init_params_is_seeded():
    m1 = vit.TransformerBlock(2, 32)
    m2 = vit.TransformerBlock(2, 32)
    init_params(m1, torch.Generator().manual_seed(3))
    init_params(m2, torch.Generator().manual_seed(3))
    for (n1, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n1
    assert float(m1.q.weight.std()) == pytest.approx(32 ** -0.5, rel=0.2)
    assert float(m1.norm_1.scale.min()) == 1.0
