"""tcnerf_torch models/ (renderer, fused, inference) against the flax
renderer and the JAX fused paths, on a tiny 1-view model (hidden 128 so the
swg path applies, 2 blocks, ViT dim 32 / 2 heads / 32^2 / hooks 1-4,
16x24 images, 8 samples). Params come from flax `init` through
`from_flax`; sampling draws are JAX's, captured with `make_rng`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnerf.models import fused as jfused
from tcnerf.models import inference as jinf
from tcnerf.models.renderer import MVNeRFRenderer as FlaxRenderer
from tcnerf_torch.data.synthetic import camera_ring
from tcnerf_torch.models import fused, inference
from tcnerf_torch.models.renderer import MVNeRFRenderer
from tcnerf_torch.ops.swg import SWG
from tcnerf_torch.params import from_flax

H, W, S, R = 16, 24, 8, 16
CFG = dict(n_views=1, n_samples=S, n_features=8, near=0.3, far=1.3,
           original_image_size=(H, W), fusion="without", n_blocks=2,
           hidden_size=128, vit_size=(32, 32), vit_dim=32, vit_heads=2,
           vit_hooks=(1, 2, 3, 4))


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(got, want, rtol=1e-3, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _draw(module, b, r, s):
    """The two `sampling` draws render_rays makes, in its order."""
    k_c = module.make_rng("sampling")
    k_f = module.make_rng("sampling")
    return (jax.random.uniform(k_c, (b, r, s)),
            jax.random.uniform(k_f, (b, r, s)))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    src_cfg, tgt_cfg = camera_ring(2, height=H, width=W, azimuth_span=0.6)
    k4 = np.eye(4, dtype=np.float32)
    k4[:3, :3] = src_cfg["intrinsics"].reshape(3, 3)
    ext = np.linalg.inv(src_cfg["pose"]).astype(np.float32)
    src = rng.uniform(size=(1, 1, H, W, 3)).astype(np.float32)
    # rays through target pixels, so samples project into the source view
    from tcnerf_torch.core.rays import get_specific_rays
    ro, rd = get_specific_rays(rng.uniform(0, W - 1, R), rng.uniform(0, H - 1, R),
                               tgt_cfg["pose"],
                               tgt_cfg["intrinsics"].reshape(3, 3))
    inputs = (ro[None].astype(np.float32), rd[None].astype(np.float32), src,
              k4[None, None], ext[None, None])
    fm = FlaxRenderer(**CFG)
    with jax.default_matmul_precision("highest"):
        variables = fm.init({"params": jax.random.PRNGKey(0),
                             "sampling": jax.random.PRNGKey(1)},
                            tuple(jnp.asarray(x) for x in inputs))
        feats = fm.apply(variables, jnp.asarray(src[0]),
                         method="combine_features")[0][None]
    state = from_flax(jax.device_get(variables["params"]))
    return dict(fm=fm, variables=variables, state=state, inputs=inputs,
                feats=np.asarray(feats), src_cfg=src_cfg, tgt_cfg=tgt_cfg)


def _port(scene, **kw):
    m = MVNeRFRenderer(**{**CFG, **kw})
    m.load_state_dict(scene["state"], strict=True)
    return m.eval()


def test_combine_features(scene):
    with torch.no_grad():
        got, aux = _port(scene).combine_features(_t(scene["inputs"][2][0]))
    assert tuple(got.shape) == (1, H, W, 8) and float(aux) == 0.0
    _close(got, scene["feats"][0])


@pytest.mark.parametrize("corner_gather,pallas_mlp", [(True, False),
                                                      (False, False),
                                                      (True, True)])
def test_render_rays_matches_flax(scene, corner_gather, pallas_mlp):
    """Port vs flax `render_rays` (flax always with pallas_mlp=False: its
    `_pallas_chain` calls the TPU kernel without interpret). f32: 1e-3."""
    fm = FlaxRenderer(**{**CFG, "corner_gather": corner_gather})
    args = tuple(jnp.asarray(x) for x in scene["inputs"]) + (
        jnp.asarray(scene["feats"]),)
    key = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("highest"):
        want = fm.apply(scene["variables"], *args, rngs={"sampling": key},
                        method="render_rays")
        u_c, u_f = fm.apply(scene["variables"], 1, R, S, method=_draw,
                            rngs={"sampling": key})
    m = _port(scene, corner_gather=corner_gather, pallas_mlp=pallas_mlp)
    with torch.no_grad():
        got = m.render_rays(*(_t(x) for x in scene["inputs"]),
                            _t(scene["feats"]), u_coarse=_t(u_c),
                            u_fine=_t(u_f))
    for g, w in zip(got, want):
        _close(g, w)


def test_fused_render_rays_matches_jax(scene):
    """fused_render_rays (resmlp chain with the input Dense and readout) vs
    JAX fused_render_rays(interpret=True). f32: 1e-3."""
    args = tuple(jnp.asarray(x) for x in scene["inputs"]) + (
        jnp.asarray(scene["feats"]),)
    key = jax.random.PRNGKey(8)
    with jax.default_matmul_precision("highest"):
        want = jfused.fused_render_rays(scene["variables"]["params"], *args,
                                        key, n_samples=S, n_blocks=2,
                                        tile=64, interpret=True)
    k_c, k_f = jax.random.split(key)
    with torch.no_grad():
        got = fused.fused_render_rays(
            _port(scene), *(_t(x) for x in scene["inputs"]),
            _t(scene["feats"]), n_samples=S, n_blocks=2,
            u_coarse=_t(jax.random.uniform(k_c, (1, R, S))),
            u_fine=_t(jax.random.uniform(k_f, (1, R, S))))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("dtype,fast", [(torch.float32, True),
                                        (torch.bfloat16, True),
                                        (torch.float32, False)])
def test_swg_render_chunk_matches_jax(scene, dtype, fast):
    """Port swg_render_chunk vs JAX swg_render_chunk(interpret=True) on the
    f32-prepared image: rtol 3e-2 / atol 2e-2, the bar of a bf16-prepared
    render chunk (test_kernels.py:738-741) — bf16 streams, and the TPU
    kernel's 11-bit lerp fractions."""
    args = tuple(jnp.asarray(x) for x in scene["inputs"])
    feats = jnp.asarray(scene["feats"])
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision("highest"):
        prep = jfused.swg_prepare(scene["variables"]["params"], args[2], feats,
                                  n_blocks=2, ka=16, fast=fast)
        want = jfused.swg_render_chunk(prep, args[0], args[1], args[3],
                                       args[4], key, n_samples=S, n_blocks=2,
                                       ka=16, bq=512, sg=1, fast=fast,
                                       interpret=True)
    assert int(want[4]) == 0
    k_c, k_f = jax.random.split(key)
    t = [_t(x) for x in scene["inputs"]]
    before = sum(SWG.counts.values())
    with torch.no_grad():
        prepared = fused.swg_prepare(_port(scene), t[2], _t(scene["feats"]),
                                     n_blocks=2, dtype=dtype)
        draws = dict(u_coarse=_t(jax.random.uniform(k_c, (1, R, S))),
                     u_fine=_t(jax.random.uniform(k_f, (1, R, S))))
        got = fused.swg_render_chunk(
            prepared, t[0], t[1], t[3], t[4], n_samples=S, n_blocks=2,
            fast=fast, **draws)
        # the single-shot form is prepare + one chunk
        once = fused.swg_render_rays(
            _port(scene), t[0], t[1], t[2], t[3], t[4], _t(scene["feats"]),
            n_samples=S, n_blocks=2, fast=fast, dtype=dtype, **draws)
    assert got[4] == 0 and sum(SWG.counts.values()) == before
    assert all(torch.equal(a, b) for a, b in zip(got[:4], once[:4]))
    for g, w in zip(got[:4], want[:4]):
        _close(g.float(), w, rtol=3e-2, atol=2e-2)


def test_full_image_matches_jax(scene):
    """The slice as a whole on the flax path: the port's full-image render
    (features encoded by the port) vs inference._render_all_rays, with the
    same per-chunk draws. f32: 1e-3 on colour and depth."""
    fm, variables = scene["fm"], scene["variables"]
    tgt = scene["tgt_cfg"]
    pose = tgt["pose"].astype(np.float32)
    k3 = tgt["intrinsics"].reshape(3, 3).astype(np.float32)
    src, k4, ext = scene["inputs"][2:]
    chunk = 128                            # 384 rays: 3 chunks
    rng = jax.random.PRNGKey(11)
    with jax.default_matmul_precision("highest"):
        want_rgb, want_depth = jinf._render_all_rays(
            fm.apply, variables, jnp.asarray(src), jnp.asarray(k4),
            jnp.asarray(ext), jnp.asarray(scene["feats"]), jnp.asarray(pose),
            jnp.asarray(k3), rng, H, W, chunk)
        draws = [tuple(_t(u) for u in fm.apply(variables, 1, chunk, S,
                                               method=_draw,
                                               rngs={"sampling": key}))
                 for key in jax.random.split(rng, H * W // chunk)]
    m = _port(scene)
    with torch.no_grad():
        feats, _ = m.combine_features(_t(src[0]))
        rgb, depth = inference.render_all_rays(
            m, _t(src), _t(k4), _t(ext), feats[None], _t(pose), _t(k3), H, W,
            chunk, draws=draws)
    assert tuple(rgb.shape) == (H, W, 3) and tuple(depth.shape) == (H, W)
    _close(rgb, want_rgb)
    _close(depth, want_depth)


def test_render_view_device_rules(scene):
    """Runs on the CPU only when asked; otherwise needs a card."""
    m = _port(scene)
    src = (scene["inputs"][2][0, 0] * 255).astype(np.uint8)
    args = (m, [src], [scene["src_cfg"]], scene["tgt_cfg"])
    rgb, depth = inference.render_view(*args, device="cpu", chunk=128,
                                       generator=torch.Generator().manual_seed(0))
    assert rgb.shape == (H, W, 3) and rgb.dtype == np.uint8
    assert depth.shape == (H, W, 1) and depth.dtype == np.uint8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            inference.render_view(*args)
    assert inference.psnr(rgb, rgb) == pytest.approx(120.0)


def test_unported_variants_raise():
    """Every field and fusion is ported (the hash-grid field is held
    against flax in tests/test_torch_hashgrid.py, v0-v4 in
    tests/test_torch_fusion.py): a hash-grid renderer builds its two
    fields and readouts and nothing else; an unknown fusion or field is
    an error."""
    m = MVNeRFRenderer(**{**CFG, "field": "hashgrid"})
    assert {k.split(".", 1)[0] for k in m.state_dict()} == {
        "coarse_embedding", "coarse_readout", "fine_embedding",
        "fine_readout"}
    with pytest.raises(ValueError):
        MVNeRFRenderer(**{**CFG, "fusion": "v5"})
    with pytest.raises(ValueError):
        MVNeRFRenderer(**{**CFG, "field": "voxels"})
