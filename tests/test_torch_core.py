"""tcnerf_torch core/, ops/interpolate, ops/sortmerge and the camera helpers
against their tcnerf counterparts on the same numpy inputs.

Tolerance: 1e-5 absolute/relative on f32 geometry, where both sides run the
same formula in full fp32 (JAX pins Precision.HIGHEST, the port disables
TF32); only summation order and libm differ.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnerf.core import encoding as jenc
from tcnerf.core import projection as jproj
from tcnerf.core import rays as jrays
from tcnerf.core import render as jrender
from tcnerf.core import sampling as jsamp
from tcnerf.data import generators as jgen
from tcnerf.data import synthetic as jsyn
from tcnerf.ops import hashgrid as jhash
from tcnerf.ops import interpolate as jinterp
from tcnerf.ops import sortmerge as jsort
from tcnerf_torch.core import encoding, projection, rays, render, sampling
from tcnerf_torch.data import generators, synthetic
from tcnerf_torch.ops import hashgrid, interpolate, sortmerge

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _cam(rng, b=1, v=2):
    ring = jsyn.camera_ring(4, height=16, width=24)
    ext = np.stack([np.linalg.inv(c["pose"]) for c in ring[:v]])
    k = np.stack([np.eye(4)] * v)
    k[:, :3, :3] = ring[0]["intrinsics"].reshape(3, 3)
    return (np.broadcast_to(k, (b, v, 4, 4)).astype(np.float32),
            np.broadcast_to(ext, (b, v, 4, 4)).astype(np.float32))


@pytest.mark.parametrize("fast", [False, True])
def test_positional_encoding(fast):
    x = np.random.default_rng(0).uniform(-1.3, 1.3, (5, 7, 3)).astype(np.float32)
    jf = jenc.positional_encoding_fast if fast else jenc.positional_encoding
    tf = encoding.positional_encoding_fast if fast else encoding.positional_encoding
    # the recurrence doubles one rounding per octave: 1e-4 at 10 octaves
    np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)


def test_get_rays_and_specific_rays():
    cfg = jsyn.camera_ring(3, height=12, width=20)[1]
    pose = cfg["pose"].astype(np.float32)
    k3 = cfg["intrinsics"].reshape(3, 3).astype(np.float32)
    jo, jd = jrays.get_rays_jax(20, 12, jnp.asarray(pose), jnp.asarray(k3))
    to, td = rays.get_rays(20, 12, _t(pose), _t(k3))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    u = np.array([0.0, 3.5, 19.0], np.float32)
    v = np.array([0.0, 7.25, 11.0], np.float32)
    for got, want in zip(rays.get_specific_rays(u, v, cfg["pose"], k3),
                         jrays.get_specific_rays(u, v, cfg["pose"], k3)):
        np.testing.assert_array_equal(got, want)


def test_sample_along_ray_with_jax_draws():
    rng = np.random.default_rng(1)
    ro = rng.normal(size=(2, 5, 3)).astype(np.float32)
    rd = rng.normal(size=(2, 5, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jp, jz = jsamp.sample_along_ray(key, jnp.asarray(ro), jnp.asarray(rd),
                                    0.3, 1.3, 8)
    u = np.asarray(jax.random.uniform(key, (2, 5, 8)))
    tp, tz = sampling.sample_along_ray(_t(ro), _t(rd), 0.3, 1.3, 8,
                                       u_jitter=_t(u))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    g = torch.Generator().manual_seed(0)
    _, z = sampling.sample_along_ray(_t(ro), _t(rd), 0.3, 1.3, 8, generator=g)
    assert bool(((z >= 0.3) & (z <= 1.3)).all())


@pytest.mark.parametrize("zero_weights", [False, True])
def test_sample_pdf_with_jax_draws(zero_weights):
    """Includes the zero-sum guard (all-zero weights) and duplicate bins."""
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(0.3, 1.3, (2, 4, 9)), -1).astype(np.float32)
    bins[0, 0, 3] = bins[0, 0, 4]
    w = (np.zeros((2, 4, 9)) if zero_weights
         else rng.uniform(0, 1, (2, 4, 9)) ** 4).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 16)
    u = np.asarray(jax.random.uniform(key, (2, 4, 16)))
    got = sampling.sample_pdf(_t(bins), _t(w), 16, u_pdf=_t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_projection_and_directions():
    rng = np.random.default_rng(3)
    k, ext = _cam(rng)
    pts = rng.uniform(0.2, 0.8, (1, 6, 5, 3)).astype(np.float32)
    # behind the camera: z clamps to Z_EPS and the pixel to +-PIXEL_CLIP
    r, t = ext[0, 0, :3, :3], ext[0, 0, :3, 3]
    pts[0, 0, 0] = r.T @ (np.array([0.3, -0.2, -0.5], np.float32) - t)
    jxy, jcam = jproj.project_points_mv(jnp.asarray(pts), jnp.asarray(k),
                                        jnp.asarray(ext))
    txy, tcam = projection.project_points_mv(_t(pts), _t(k), _t(ext))
    np.testing.assert_allclose(tcam.numpy(), np.asarray(jcam), rtol=1e-5,
                               atol=1e-5)
    # x/z with z near 0 in the second view amplifies the f32 rounding of z
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=1e-3)
    d = rng.normal(size=(1, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        projection.world_to_camera_directions_mv(_t(d), _t(ext)).numpy(),
        np.asarray(jproj.world_to_camera_directions_mv(jnp.asarray(d),
                                                       jnp.asarray(ext))),
        **TOL)


def test_volumetric_render():
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(0.3, 1.3, (2, 3, 8)), -1).astype(np.float32)
    sigma = rng.normal(size=(2, 3, 8)).astype(np.float32) * 5
    rgb = rng.uniform(size=(2, 3, 8, 3)).astype(np.float32)
    want = jrender.volumetric_render(jnp.asarray(z), jnp.asarray(sigma),
                                     jnp.asarray(rgb))
    got = render.volumetric_render(_t(z), _t(sigma), _t(rgb))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_bilinear_gathers_with_clamps():
    """Queries beyond every edge: the floor clamps to [0, size-2] and the
    fractions come from the clamped query."""
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)
    xy = rng.uniform(-3, 12, (2, 40, 2)).astype(np.float32)
    xy[0, :4] = [[0, 0], [8, 6], [8.0, 0.5], [-1e6, 1e6]]
    want = np.asarray(jinterp.bilinear_gather(jnp.asarray(img), jnp.asarray(xy)))
    np.testing.assert_allclose(
        interpolate.bilinear_gather(_t(img), _t(xy)).numpy(), want, **TOL)
    corner = interpolate.make_corner_image(_t(img))
    np.testing.assert_array_equal(
        corner.numpy(), np.asarray(jinterp.make_corner_image(jnp.asarray(img))))
    np.testing.assert_allclose(
        interpolate.bilinear_gather_corners(corner, _t(xy)).numpy(), want,
        **TOL)


def test_gather_projection_features():
    rng = np.random.default_rng(6)
    imgs = rng.uniform(-1, 1, (1, 2, 6, 8, 3)).astype(np.float32)
    feats = rng.normal(size=(1, 2, 6, 8, 4)).astype(np.float32)
    xy = rng.uniform(-1, 9, (1, 2, 3, 5, 2)).astype(np.float32)
    want = jinterp.gather_projection_features(
        jnp.asarray(imgs), jnp.asarray(feats), jnp.asarray(xy))
    got = interpolate.gather_projection_features(_t(imgs), _t(feats), _t(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sort_and_merge():
    rng = np.random.default_rng(7)
    a = np.sort(rng.normal(size=(3, 16)), -1).astype(np.float32)
    b = rng.normal(size=(3, 16)).astype(np.float32)
    b[:, :3] = a[:, 5:6]                          # ties across the two
    sb = sortmerge.sort_small(_t(b))
    np.testing.assert_array_equal(
        sb.numpy(), np.asarray(jsort.sort_small(jnp.asarray(b))))
    np.testing.assert_array_equal(
        sortmerge.merge_sorted(_t(a), sb).numpy(),
        np.asarray(jsort.merge_sorted(jnp.asarray(a), jnp.asarray(sb.numpy()))))


def test_camera_helpers():
    for got, want in zip(synthetic.camera_ring(5, azimuth_span=1.2),
                         jsyn.camera_ring(5, azimuth_span=1.2)):
        np.testing.assert_array_equal(got["pose"], want["pose"])
        np.testing.assert_array_equal(got["intrinsics"], want["intrinsics"])
        for a, b in zip(generators.camera_parameters(got),
                        jgen.camera_parameters(want)):
            np.testing.assert_array_equal(a, b)


def _hash_case(x):
    kw = dict(n_levels=2, table_size_log2=6)
    jcfg, cfg = jhash.HashGridConfig(**kw), hashgrid.HashGridConfig(**kw)
    tables = np.random.default_rng(11).uniform(-1, 1, (2, 64, 2)).astype(
        np.float32)
    return (lambda p: jhash.hash_encode(jnp.asarray(tables), p, jcfg),
            lambda p: hashgrid.hash_encode(_t(tables), p, cfg),
            np.array([x], np.float32), hashgrid)


def _gather_case(corners, xy):
    img = np.random.default_rng(12).normal(size=(1, 4, 5, 2)).astype(
        np.float32)
    if corners:
        jimg = jinterp.make_corner_image(jnp.asarray(img))
        timg = interpolate.make_corner_image(_t(img))
        return (lambda c: jinterp.bilinear_gather_corners(jimg, c),
                lambda c: interpolate.bilinear_gather_corners(timg, c),
                np.array([[xy]], np.float32), interpolate)
    return (lambda c: jinterp.bilinear_gather(jnp.asarray(img), c),
            lambda c: interpolate.bilinear_gather(_t(img), c),
            np.array([[xy]], np.float32), interpolate)


def _project_case(fn, point):
    """An identity camera: the pixel is (x / z, y / z), so x = 1e6 at z = 1
    sits on PIXEL_CLIP and z = 1e-8 (f32) on Z_EPS."""
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 1, 4, 4))
    return (lambda p: getattr(jproj, fn)(p, jnp.asarray(eye),
                                         jnp.asarray(eye))[0],
            lambda p: getattr(projection, fn)(p, _t(eye), _t(eye))[0],
            np.array(point, np.float32).reshape(1, 1, 1, 3), projection)


BOUND_TIES = {
    # the box's lower x face; the upper x and z faces; inside
    "hash_encode-lower-face": lambda: _hash_case((0.35, 0.0, 0.1)),
    "hash_encode-upper-faces": lambda: _hash_case((0.85, 0.1, 0.2)),
    "hash_encode-interior": lambda: _hash_case((0.6, 0.05, 0.13)),
    # x = w - 1, x = 0, y = h - 1 on a [1, 4, 5, 2] image; inside
    **{f"{name}-{tag}": functools.partial(_gather_case, corners, xy)
       for name, corners in (("bilinear_gather", False),
                             ("bilinear_gather_corners", True))
       for tag, xy in (("x-upper", (4.0, 1.3)), ("x-lower", (0.0, 2.2)),
                       ("y-upper", (2.5, 3.0)), ("interior", (1.7, 2.2)))},
    "project_points_mv-pixel-clip": lambda: _project_case(
        "project_points_mv", (1e6, 0.5, 1.0)),
    "project_probe_points-z-eps": lambda: _project_case(
        "project_probe_points", (1e-9, 2e-9, 1e-8)),
    "project_points_mv-interior": lambda: _project_case(
        "project_points_mv", (0.3, -0.2, 0.9)),
}


@pytest.mark.parametrize("case", sorted(BOUND_TIES))
def test_gradient_at_a_bound_tie_matches_jax(case, monkeypatch):
    """At a point exactly on a clip bound, JAX's `maximum` / `minimum` pass
    half of the gradient to each side and `torch.clamp` passed all of it
    (hash_encode 934.21 against 467.11, bilinear_gather 2.0486 against
    1.0243): the port's gradient in the point equals the jitted
    `jax.grad`'s at 1e-6 of its largest entry, inside the bounds too. The
    forward is the JAX function's at 1e-6 relative and, bit for bit, what
    it was with `torch.clamp`."""
    jfn, tfn, x, module = BOUND_TIES[case]()
    jout = np.asarray(jax.jit(jfn)(x))
    w = np.random.default_rng(13).normal(size=jout.shape).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(jfn(p) * w)))(x))
    p = _t(x).requires_grad_()
    out = tfn(p)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-6,
                               atol=1e-6)
    (got,) = torch.autograd.grad(torch.sum(out * _t(w)), p)
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    monkeypatch.setattr(module, "clip",
                        lambda v, lo=None, hi=None: torch.clamp(v, lo, hi))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  tfn(_t(x)).numpy())
