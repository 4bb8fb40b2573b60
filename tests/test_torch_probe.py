"""The probe chain (`ops/probe.py`) on the CPU: when `GraspEBM` takes it,
the wrapper's argument checks, and the kernels' arithmetic as the packed
weight streams give it, held against autograd of the plain path in f64.
The kernels themselves run in tests/test_torch_gpu.py (marked `gpu`)."""

import numpy as np
import pytest
import torch

from tcnerf_torch.core.encoding import positional_encoding
from tcnerf_torch.models.grasp import GraspEBM
from tcnerf_torch.ops.interpolate import bilinear_gather_corners, make_corner_image
from tcnerf_torch.ops.probe import (CHUNK, PROBE, pack_probe, probe_chain,
                                    probe_fits, probe_grad_free, probe_taps)
from tcnerf_torch.params import init_params

H, W = 12, 16


def _model(n_blocks=6, activation="elu", **kw):
    m = GraspEBM(n_views=1, n_features=8, original_image_size=(H, W),
                 n_5d_poses=3, n_blocks=n_blocks, hidden_size=128,
                 vit_size=(32, 32), vit_dim=32, vit_heads=2,
                 vit_hooks=(1, 2, 3, 4), readout_activation=activation, **kw)
    init_params(m, torch.Generator().manual_seed(0))
    return m.eval()


def _rows(rng, n, images=2):
    """n rows an image: pixel xy mostly inside, some outside, and a few on
    the clamps' bounds exactly (their gradient factor is a half)."""
    xy = np.stack([rng.uniform(-2, W + 1, (images, n)),
                   rng.uniform(-2, H + 1, (images, n))], -1)
    xy[0, :4] = [[0.0, 3.5], [W - 1.0, 2.25], [5.5, 0.0], [7.25, H - 1.0]]
    pos = rng.normal(size=(images, n, 3)) * 0.3
    dirs = rng.normal(size=(images, n, 3)) * 0.5
    corner = make_corner_image(torch.as_tensor(
        rng.normal(size=(images, H, W, 128)), dtype=torch.float32))
    f32 = [torch.as_tensor(a.reshape(-1, a.shape[-1]), dtype=torch.float32)
           for a in (xy, pos, dirs)]
    return f32 + [corner.contiguous()]


def test_cpu_and_f64_take_the_plain_path():
    """On the CPU, and in f64, `energy_prepared` never launches the
    kernels, though the chain and readout fit them."""
    m = _model()
    assert probe_fits(m.probe_weights())
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.uniform(size=(2, 1, H, W, 3)),
                             dtype=torch.float32)
    poses = torch.eye(4).repeat(2, 5, 1, 1)
    poses[..., :3, 3] = torch.as_tensor(rng.uniform(0.3, 0.6, (2, 5, 3)))
    k4 = torch.eye(4).repeat(2, 1, 1, 1)
    k4[..., 0, 0] = k4[..., 1, 1] = 20.0
    k4[..., 0, 2], k4[..., 1, 2] = W / 2, H / 2
    ext = torch.eye(4).repeat(2, 1, 1, 1)
    before = dict(PROBE.counts)
    for dt in (torch.float32, torch.float64):
        m = m.to(dt)
        with torch.no_grad():
            feats = m.encode(images.to(dt))
        prep = m.prepare(images.to(dt), feats)
        assert not m.probe_kernel_engages(poses.to(dt), prep)
        e = m.energy_prepared(poses.to(dt), prep, k4.to(dt), ext.to(dt))
        assert e.shape == (2, 5) and torch.isfinite(e).all()
    assert dict(PROBE.counts) == before


def test_probe_chain_on_cpu_is_the_plain_path():
    """On the CPU the chain is `GraspEBM.probe_chain_plain`: the plain
    path's readout inputs (the view mean and the fusion blocks' outputs)
    through the readout's per-probe part. `probe_chain` runs the kernels
    alone and sends CPU rows there."""
    m = _model()
    coords, pos, dirs, corner = _rows(np.random.default_rng(1), 7)
    got = m.probe_chain_plain(coords, pos, dirs, corner, 7)
    feats = bilinear_gather_corners(corner, coords.reshape(2, 7, 2))
    acts = m.fine_embedding(pos, dirs, feats.reshape(14, -1),
                            features_projected=True)
    want = m.grasp_readout.probe_features(acts[4:])
    assert got.shape == (14, 64) and torch.equal(got, want)
    m.requires_grad_(False)
    with pytest.raises(ValueError, match="GraspEBM.probe_chain_plain"):
        probe_chain(coords, pos, dirs, corner, 7, m._probe_pack())


@pytest.mark.parametrize("case", ["f64", "shape", "strided", "corner_width",
                                  "rows", "narrow_model", "trainable",
                                  "corner_grad"])
def test_probe_chain_raises_on_what_the_kernels_do_not_take(case):
    """Each fault is named before the rows are sent to the card."""
    m = _model().requires_grad_(False)
    coords, pos, dirs, corner = _rows(np.random.default_rng(2), 5)
    args = [coords, pos, dirs, corner, 5]
    if case == "narrow_model":
        small = GraspEBM(n_views=1, n_features=8, original_image_size=(H, W),
                         n_5d_poses=3, n_blocks=2, hidden_size=32,
                         vit_size=(32, 32), vit_dim=32, vit_heads=2,
                         vit_hooks=(1, 2, 3, 4))
        assert small._probe_pack() is None
        with pytest.raises(ValueError, match="pack_probe"):
            pack_probe(small.probe_weights())
        return
    pack = m._probe_pack()
    if case == "f64":
        args[1], fault = pos.double(), "pos must be contiguous f32"
    elif case == "shape":
        args[0] = torch.cat([coords, coords[:, :1]], 1)
        fault = "coords must be contiguous f32"
    elif case == "strided":
        args[2] = torch.cat([dirs, dirs], 1)[:, ::2]
        fault = "dirs must be contiguous f32"
    elif case == "corner_width":
        args[3], fault = corner[..., :256].contiguous(), "corner must be"
    elif case == "rows":
        args[4], fault = 4, "2 images of 4 rows are not 10 rows"
    elif case == "trainable":
        m.grasp_readout.combined_activation_downscale.bias.requires_grad_()
        fault = "would take a gradient"
    else:
        args[3], fault = corner.clone().requires_grad_(), "would take a grad"
    with pytest.raises(ValueError, match=f"probe_chain: .*{fault}"):
        probe_chain(*args, pack)


def test_the_pack_follows_the_weights_and_the_grad_rule():
    """`GraspEBM._probe_pack` is packed again after an in-place update of
    a weight it reads, and only then; `probe_grad_free` turns false where a
    weight or the corner image requires grad in grad mode."""
    m = _model()
    first = m._probe_pack()
    assert m._probe_pack() is first
    m.fine_embedding.feature_blocks[1].layer_1.weight.requires_grad_(False)
    m.grasp_readout.readout_head.requires_grad_(False)
    assert m._probe_pack() is first
    with torch.no_grad():
        m.fine_embedding.fusion_blocks[0].layer_0.weight.mul_(2.0)
    second = m._probe_pack()
    assert second is not first and not torch.equal(second.fwd, first.fwd)
    assert torch.equal(second.fwd, pack_probe(m.probe_weights()).fwd)
    corner = torch.zeros((1, 2, 2, 512))
    for p in m.parameters():
        p.requires_grad_(False)
    assert probe_grad_free(second, corner)
    assert not probe_grad_free(second, corner.requires_grad_())
    m.fine_embedding.layer_0.bias.requires_grad_()
    assert not probe_grad_free(second, corner.detach())
    with torch.no_grad():
        assert probe_grad_free(second, corner)


def _stencil(c, size):
    x = c.clamp(0.0, size - 1.0)
    x0 = torch.floor(x).clamp(0.0, size - 2.0)
    lo = torch.where(c > 0, 1.0, torch.where(c == 0, 0.5, 0.0))
    m = c.clamp(min=0.0)
    hi = torch.where(m < size - 1, 1.0, torch.where(m == size - 1, 0.5, 0.0))
    return x - x0, x0.long(), (lo * hi).to(c.dtype)


def _emulate(pack, coords, pos, dirs, corner, rpi, gout):
    """The kernels' forward and backward over the packed streams, in f64:
    each product takes the next chunks of its stream as [k][n]."""
    act = torch.nn.functional.elu if pack.elu else torch.relu

    def dact(z):
        return (torch.where(z <= 0, torch.exp(z), torch.ones_like(z))
                if pack.elu else (z > 0).to(z.dtype))

    def walker(stream):
        chunks = stream.double().reshape(-1, CHUNK)
        at = [0]

        def take(k, n):
            c = k * n // CHUNK
            at[0] += c
            return chunks[at[0] - c:at[0]].reshape(k, n)
        return take

    rows = coords.shape[0]
    tap0, n_taps = probe_taps(pack.n_blocks)
    bias = pack.bias.double()
    taps_at = 128 + 256 * pack.n_blocks      # the biases as the kernel reads them
    feats = bilinear_gather_corners(
        corner, coords.reshape(-1, rpi, 2)).reshape(rows, -1)
    enc = torch.cat([positional_encoding(pos, pack.n_freq, pack.base_freq),
                     positional_encoding(dirs, pack.n_freq, pack.base_freq),
                     pos.new_zeros((rows, 128 - 12 * pack.n_freq))], -1)
    take = walker(pack.fwd)
    h = (enc @ take(128, 128) + bias[:128]) + feats
    mh, mz, s_pre = [], [], []
    c = 0.0
    for b in range(pack.n_blocks):
        b0 = bias[128 + 256 * b:256 + 256 * b]
        b1 = bias[256 + 256 * b:384 + 256 * b]
        mh.append(h > 0)
        z = torch.relu(h) @ take(128, 128) + b0
        mz.append(z > 0)
        h = h + (torch.relu(z) @ take(128, 128) + b1)
        j = b - tap0
        if 0 <= j < n_taps:
            s_pre.append(h @ take(128, 64) + bias[taps_at + 64 * j:
                                                   taps_at + 64 * j + 64])
            c = c + act(s_pre[-1]) @ take(64, 64)
    c = c + bias[taps_at + 64 * n_taps:]
    out = act(c)

    take = walker(pack.bwd)
    gc = gout * dact(c)
    g = torch.zeros_like(h)
    for b in reversed(range(pack.n_blocks)):
        j = b - tap0
        if 0 <= j < n_taps:
            gs = (gc @ take(64, 64)) * dact(s_pre[j])
            g = g + gs @ take(64, 128)
        gz = (g @ take(128, 128)) * mz[b]
        g = g + (gz @ take(128, 128)) * mh[b]
    genc = g @ take(128, 128)
    img = torch.arange(rows) // rpi
    n, hgt, wid = corner.shape[0], corner.shape[1], corner.shape[2]
    ax, x0, fx = _stencil(coords[:, 0], wid)
    ay, y0, fy = _stencil(coords[:, 1], hgt)
    v = corner.reshape(n * hgt * wid, 4, 128)[(img * hgt + y0) * wid + x0]
    dx0, dx1 = v[:, 1] - v[:, 0], v[:, 3] - v[:, 2]
    top, bot = v[:, 0] + ax[:, None] * dx0, v[:, 2] + ax[:, None] * dx1
    gx = (g * ((1 - ay[:, None]) * dx0 + ay[:, None] * dx1)).sum(-1) * fx
    gy = (g * (bot - top)).sum(-1) * fy
    f = pack.base_freq * 2.0 ** torch.arange(pack.n_freq, dtype=torch.float64)
    gp = []
    for d, x in enumerate(list(pos.t()) + list(dirs.t())):
        ge = genc[:, 2 * pack.n_freq * d:2 * pack.n_freq * (d + 1)]
        s = x[:, None] * f
        gp.append(((ge[:, 0::2] * torch.cos(s) - ge[:, 1::2] * torch.sin(s))
                   * f).sum(-1))
    return out, torch.stack([gx, gy] + gp, -1)


@pytest.mark.parametrize("n_blocks,activation", [(6, "elu"), (4, "relu")])
def test_packed_streams_compute_the_chain_and_its_pose_gradient(
        n_blocks, activation):
    """The arithmetic the kernels run, stream chunk by chunk, against the
    plain path and autograd in f64 (weights exact in f32, so the f32 pack
    holds them): forward [rows, 64] and d(<out, gout>)/d(xy, pos, dir)."""
    m = _model(n_blocks, activation)
    pack = pack_probe(m.probe_weights())
    assert pack.fwd.numel() == pack.bwd.numel() == 128 * 128 * (
        1 + 2 * n_blocks) + probe_taps(n_blocks)[1] * (128 * 64 + 64 * 64)
    assert pack.fwd.numel() % CHUNK == 0
    m = m.double()
    rng = np.random.default_rng(3)
    coords, pos, dirs, corner = (t.double() for t in _rows(rng, 9))
    gout = torch.as_tensor(rng.normal(size=(18, 64)))
    ins = [t.clone().requires_grad_() for t in (coords, pos, dirs)]
    want = m.probe_chain_plain(*ins, corner, 9)
    grads = torch.autograd.grad((want * gout).sum(), ins)
    got, gin = _emulate(pack, coords, pos, dirs, corner, 9, gout)
    scale = float(want.detach().abs().max())
    assert float((got - want.detach()).abs().max()) <= 1e-10 * scale
    want_g = torch.cat(grads, -1)
    assert float((gin - want_g).abs().max()) <= 1e-9 * float(
        want_g.abs().max())
