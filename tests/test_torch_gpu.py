"""tcnerf_torch CUDA kernels against their plain versions on the card
(marked `gpu`; they skip where no card is present), and the shared input
helpers of the kernel tests.

This file imports no JAX, so it also runs on a machine without it:

    python3 -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu

(`--noconftest` because tests/conftest.py sets up JAX).
"""

import functools
import os

import numpy as np
import pytest
import torch

from tcnerf_torch.ops.gather import (GATHER, ONEHOT_MAX_WIN, gather_lanes,
                                     gather_lanes_plain, gather_onehot,
                                     gather_onehot_plain, gather_rows,
                                     gather_rows_plain, gather_rows_window)
from tcnerf_torch.models import training
from tcnerf_torch.models.renderer import MVNeRFRenderer
from tcnerf_torch.nn.mlp import MVResNetMLPEmbedding
from tcnerf_torch.ops.resmlp import (RESMLP, pack_chain, resmlp_plain,
                                     resmlp_rows, resmlp_rows_diff)
from tcnerf_torch.params import init_params
from tcnerf_torch.ops.swg import (SWG, encode_head, pack_swg, swg_field_plain,
                                  swg_field_rows)

HID = 128

# (readout, skip_input, fast)
RESMLP_CASES = [(False, True, False), (True, False, False),
                (False, True, True), (True, False, True)]


def _chain(rng, n_blocks, d_in=None, out_dim=None):
    flat = [] if d_in is None else [rng.normal(size=(d_in, HID)) / np.sqrt(d_in),
                                    rng.normal(size=(HID,)) * 0.1]
    for _ in range(n_blocks):
        flat += [rng.normal(size=(HID, HID)) * 0.09, rng.normal(size=(HID,)) * 0.1,
                 rng.normal(size=(HID, HID)) * 0.09, rng.normal(size=(HID,)) * 0.1]
    if out_dim:
        flat += [rng.normal(size=(HID, out_dim)) * 0.09,
                 rng.normal(size=(out_dim,)) * 0.1]
    return [w.astype(np.float32) for w in flat]


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _tt(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a, np.float32)).to(dtype)


def _swg_inputs(rng, n, h=16, w=24, n_blocks=2, margin=0.0):
    """margin > 0 puts queries outside the image (clamped). The TPU fast
    path packs both 11-bit fractions into one f32 and cannot carry ay == 1
    (a query clamped to the last row), so its parity runs inside."""
    img = rng.normal(size=(h, w, HID)).astype(np.float32)
    coords = np.stack([rng.uniform(-margin, w - 1 + margin, n),
                       rng.uniform(-margin, h - 1 + margin, n)],
                      -1).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    dirs = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    head_k = (rng.normal(size=(120, HID)) * 0.05).astype(np.float32)
    head_b = (rng.normal(size=(HID,)) * 0.1).astype(np.float32)
    flat = _chain(rng, n_blocks, None, 4)
    return img, coords, pos, dirs, head_k, head_b, flat


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


# (rows, n_blocks, out_dim): n = 1, 65 and 1000 are not multiples of the
# kernel's 128-row step; 40,000 rows make every one of ~132 persistent CTAs
# walk several steps; 0 blocks leaves the weight ring empty
RESMLP_SHAPES = [(1000, 3, 4), (1, 3, 4), (65, 0, 1), (777, 6, 8),
                 (40000, 1, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("n,n_blocks,out_dim", RESMLP_SHAPES)
@pytest.mark.parametrize("activation", ["relu", "elu"])
@pytest.mark.parametrize("readout,skip_input,fast", RESMLP_CASES)
def test_resmlp_kernel_matches_plain(cuda, readout, skip_input, fast,
                                     activation, n, n_blocks, out_dim,
                                     x_dtype):
    """Kernel vs plain on the card, bf16 weights: 2e-2 x max|ref| (bf16
    operands; roundings can differ in the last bit). The input Dense form
    takes 379-wide rows (758 or 1516 bytes apart, not 16-byte aligned)."""
    rng = np.random.default_rng(4)
    d_in = None if skip_input else 379
    flat = [_tt(w, torch.bfloat16).to(cuda)
            for w in _chain(rng, n_blocks, d_in, out_dim if readout else None)]
    x = _tt(rng.normal(size=(n, HID if skip_input else d_in)),
            x_dtype).to(cuda)
    before = RESMLP.counts["resmlp_rows"]
    kw = dict(readout=readout, skip_input=skip_input, fast=fast,
              activation=activation)
    got = resmlp_rows(x, flat, n_blocks, **kw)
    torch.cuda.synchronize()
    assert RESMLP.counts["resmlp_rows"] == before + 1
    want = resmlp_plain(x, flat, n_blocks, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


# (queries, n_blocks, out_dim, activation)
SWG_SHAPES = [(3000, 6, 4, "relu"), (1, 6, 4, "relu"), (65, 0, 1, "elu"),
              (1000, 1, 8, "elu"), (40000, 2, 4, "relu")]


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_blocks,out_dim,activation", SWG_SHAPES)
@pytest.mark.parametrize("head_inside", [True, False])
def test_swg_kernel_matches_plain(cuda, head_inside, n, n_blocks, out_dim,
                                  activation):
    """K2 (head inside, bf16 stream) and K3 (head given, f32 stream) vs the
    plain version: 2e-2 x max|ref| (bf16 operands). Queries fall inside,
    outside and exactly on the image's edges and corners (clamped)."""
    rng = np.random.default_rng(5)
    h, w = 48, 64
    img, coords, pos, dirs, head_k, head_b, _ = _swg_inputs(
        rng, n, h, w, n_blocks=0, margin=2.0)
    edges = np.array([[0, 0], [w - 1, h - 1], [w - 1, 0], [0, h - 1],
                      [w - 1, 7.5], [3.25, h - 1], [-1, -1], [w, h]],
                     np.float32)
    coords[:len(edges)] = edges[:n]
    flat = _chain(rng, n_blocks, None, out_dim)
    bf = torch.bfloat16
    timg = _tt(img, bf).to(cuda)
    tflat = [_tt(x, bf).to(cuda) for x in flat]
    tc, tp, td = (_tt(a).to(cuda) for a in (coords, pos, dirs))
    hk, hb = _tt(head_k).to(cuda), _tt(head_b).to(cuda)
    if head_inside:
        args = (timg, tc, tp, td, tflat, n_blocks, hk, hb)
        kw = dict(activation=activation)
    else:
        args = (timg, tc, None, None, tflat, n_blocks)
        kw = dict(h0_geo=encode_head(tp, td, hk, hb, bf), fast=False,
                  activation=activation)
    before = sum(SWG.counts.values())
    got = swg_field_rows(*args, **kw)
    torch.cuda.synchronize()
    assert sum(SWG.counts.values()) == before + 1
    want = swg_field_plain(*args, **kw)
    assert got.shape == want.shape == (n, out_dim)
    _close(got.cpu().numpy(), want.cpu().numpy(), 2e-2)


@pytest.mark.gpu
def test_kernels_take_prebuilt_packs(cuda):
    """A pack built once (as the serving paths do) gives the kernel the same
    weights as packing per call: identical outputs."""
    rng = np.random.default_rng(10)
    flat = [_tt(w, torch.bfloat16).to(cuda) for w in _chain(rng, 2, None, 4)]
    x = _tt(rng.normal(size=(300, HID)), torch.bfloat16).to(cuda)
    pack = pack_chain(flat, 2, readout=True, skip_input=True)
    kw = dict(readout=True, skip_input=True)
    assert torch.equal(resmlp_rows(x, flat, 2, **kw, pack=pack),
                       resmlp_rows(x, flat, 2, **kw))
    img, coords, pos, dirs, head_k, head_b, _ = _swg_inputs(rng, 300)
    args = (_tt(img, torch.bfloat16).to(cuda), _tt(coords).to(cuda),
            _tt(pos).to(cuda), _tt(dirs).to(cuda), flat, 2,
            _tt(head_k).to(cuda), _tt(head_b).to(cuda))
    pack = pack_swg(flat, 2, args[6], args[7])
    assert torch.equal(swg_field_rows(*args, pack=pack), swg_field_rows(*args))


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor the kernel cannot take raises; nothing falls back to
    the plain version and no launch is counted."""
    rng = np.random.default_rng(6)
    flat = [_tt(w, torch.bfloat16).to(cuda) for w in _chain(rng, 1)]
    before = RESMLP.counts["resmlp_rows"]
    with pytest.raises(ValueError):          # f32 weights
        resmlp_rows(_tt(rng.normal(size=(8, HID))).to(cuda),
                    [w.float() for w in flat], 1, skip_input=True)
    with pytest.raises(ValueError):          # hidden width other than 128
        resmlp_rows(_tt(rng.normal(size=(8, 64)), torch.bfloat16).to(cuda),
                    flat, 1, skip_input=True)
    with pytest.raises(ValueError):          # a pack of other weights
        resmlp_rows(_tt(rng.normal(size=(8, HID)), torch.bfloat16).to(cuda),
                    flat, 1, skip_input=True,
                    pack=pack_chain(flat + flat, 2, skip_input=True))
    assert RESMLP.counts["resmlp_rows"] == before
    flat = [_tt(w, torch.bfloat16).to(cuda) for w in _chain(rng, 1, None, 4)]
    img = torch.zeros((4, 4, HID), dtype=torch.float32, device=cuda)
    before = sum(SWG.counts.values())
    with pytest.raises(ValueError):          # f32 image
        swg_field_rows(img, torch.zeros((2, 2), device=cuda), None, None,
                       flat, 1, h0_geo=torch.zeros((2, HID), device=cuda,
                                                   dtype=torch.bfloat16))
    assert sum(SWG.counts.values()) == before


def _edge_idx(rng, n, rows):
    """n indices in [0, rows), the first and last row among them."""
    idx = rng.integers(0, rows, size=n).astype(np.int32)
    idx[:2] = (0, rows - 1)
    idx[-2:] = (rows - 1, 0)
    return idx


def _launch(name, fn, *args):
    before = GATHER.counts[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert GATHER.counts[name] == before + 1
    return out


# (kernel, table rows, row width); n = 1000 is not a multiple of any tile
ROW_CASES = [(gather_rows, 3000, 512), (gather_rows, 5, 8),
             (gather_rows_window, 2048, 512), (gather_rows_window, 2048, 128),
             (gather_rows_window, 100, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fn,rows,width", ROW_CASES,
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_gather_rows_kernels_match_plain(cuda, fn, rows, width, dtype):
    """G1 and G2 against index_select, bit for bit (a gather moves bits)."""
    rng = np.random.default_rng(7)
    table = _tt(rng.normal(size=(rows, width)), dtype).to(cuda)
    idx = torch.as_tensor(_edge_idx(rng, 1000, rows)).to(cuda)
    got = _launch(fn.__name__, fn, table, idx)
    assert torch.equal(got, gather_rows_plain(table, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_lanes_kernel_matches_plain(cuda, dtype):
    """G3 against torch.gather, bit for bit; lanes 0 and 127 included."""
    rng = np.random.default_rng(8)
    src = _tt(rng.normal(size=(1000, HID)), dtype).to(cuda)
    idx = np.stack([_edge_idx(rng, HID, HID) for _ in range(1000)])
    idx = torch.as_tensor(idx).to(cuda)
    got = _launch("gather_lanes", gather_lanes, src, idx)
    assert torch.equal(got, gather_lanes_plain(src, idx))


# (rows, cols): a table of 40,000 1 KB rows is four of G1's 12 MB bands
BAND_TABLES = {torch.bfloat16: (40000, 512), torch.float32: (40000, 256)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lo,n", [(0, 99999), (36864, 1000), (0, 1)],
                         ids=["ragged", "last-band", "n1"])
def test_gather_rows_walks_bands(cuda, dtype, lo, n):
    """G1 on a table of several bands against index_select, bit for bit:
    indices over the whole table with a ragged n (not a multiple of the
    chunk or of a CTA's slice), all in the last band, and one query."""
    rng = np.random.default_rng(10)
    rows, cols = BAND_TABLES[dtype]
    table = _tt(rng.normal(size=(rows, cols)), dtype).to(cuda)
    idx = rng.integers(lo, rows, size=n).astype(np.int32)
    idx[-1] = rows - 1
    idx = torch.as_tensor(idx).to(cuda)
    got = _launch("gather_rows", gather_rows, table, idx)
    assert torch.equal(got, table.index_select(0, idx.long()))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [16, 48, 512, 2048, ONEHOT_MAX_WIN])
@pytest.mark.parametrize("n", [1000, 1])
@pytest.mark.parametrize("column", [False, True])
def test_gather_onehot_kernel_matches_plain(cuda, rows, n, column):
    """G4 against its plain version and index_select, bit for bit: each
    output element is one product 1.0 * x plus zeros in f32. Windows of one
    block, three blocks, K9's, K13's (four column slabs) and the largest
    (16-column slabs); indices at random, all in one k16 block, every block
    hit; -1 and W give zero rows."""
    rng = np.random.default_rng(9)
    win = _tt(rng.normal(size=(rows, HID)), torch.bfloat16).to(cuda)
    one_block = rng.integers(rows - 16, rows, size=n).astype(np.int32)
    every = (np.arange(n) * 7 % rows).astype(np.int32)
    for idx in (_edge_idx(rng, n, rows) if n > 1 else
                rng.integers(0, rows, size=1).astype(np.int32),
                one_block, every):
        idx = torch.as_tensor(idx).to(cuda)
        if column:
            idx = idx[:, None].contiguous()
        got = _launch("gather_onehot", gather_onehot, win, idx)
        assert torch.equal(got, gather_onehot_plain(win, idx))
        assert torch.equal(got, win.index_select(0, idx.reshape(-1).long()))
    if n > 1:
        idx = torch.as_tensor(_edge_idx(rng, n, rows)).to(cuda)
        idx[3:5] = torch.tensor([-1, rows], dtype=torch.int32)
        got = _launch("gather_onehot", gather_onehot, win, idx)
        assert torch.equal(got, gather_onehot_plain(win, idx))
        assert not got[3:5].any()
        keep = torch.ones(n, dtype=torch.bool, device=cuda)
        keep[3:5] = False
        assert torch.equal(got[keep],
                           win.index_select(0, idx[keep].long()))


@pytest.mark.gpu
def test_gather_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """Nothing falls back to the plain version; no launch is counted."""
    bf = torch.bfloat16
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    before = dict(GATHER.counts)
    bad = [
        (gather_rows, torch.zeros((8, 4), dtype=bf, device=cuda), idx),
        (gather_rows, torch.zeros((8, 8), dtype=bf, device=cuda), idx.long()),
        (gather_rows, torch.zeros((8, 8), dtype=torch.float16, device=cuda),
         idx),
        (gather_rows_window, torch.zeros((16384, 8), dtype=bf, device=cuda),
         idx),
        (gather_rows_window, torch.zeros((8, 16), dtype=bf, device=cuda)[:, :8],
         idx),
        (gather_lanes, torch.zeros((64, 64), dtype=bf, device=cuda),
         torch.zeros((64, 64), dtype=torch.int32, device=cuda)),
        (gather_lanes, torch.zeros((64, HID), dtype=bf, device=cuda),
         torch.zeros((64, HID), dtype=torch.int32)),
        (gather_onehot, torch.zeros((512, HID), device=cuda), idx),
        (gather_onehot, torch.zeros((40, HID), dtype=bf, device=cuda), idx),
        (gather_onehot, torch.zeros((ONEHOT_MAX_WIN + 16, HID), dtype=bf,
                                    device=cuda), idx),
    ]
    for fn, data, ix in bad:
        with pytest.raises(ValueError):
            fn(data, ix)
    assert dict(GATHER.counts) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("skip_input,readout", [(True, False), (False, True)])
def test_resmlp_rows_diff_matches_plain(cuda, dtype, skip_input, readout):
    """K1' on the card. Forward: the kernel (one launch) vs the plain chain
    on the weights' bf16 copies, 2e-2 x max|ref|. Backward: autograd
    through the plain chain with the weights as given, bit for bit (the
    same code on the same inputs)."""
    rng = np.random.default_rng(11)
    d_in = None if skip_input else 379
    flat = [_tt(w, dtype).to(cuda)
            for w in _chain(rng, 3, d_in, 4 if readout else None)]
    x = _tt(rng.normal(size=(1000, d_in or HID)), dtype).to(cuda)
    x.requires_grad_()
    ws = [w.clone().requires_grad_() for w in flat]
    kw = dict(readout=readout, skip_input=skip_input)
    before = RESMLP.counts["resmlp_rows_diff"]
    out = resmlp_rows_diff(x, ws, 3, **kw)
    torch.cuda.synchronize()
    assert RESMLP.counts["resmlp_rows_diff"] == before + 1
    want = resmlp_plain(x.detach(), [w.to(torch.bfloat16) for w in flat], 3,
                        **kw)
    assert out.dtype == dtype and out.shape == want.shape
    _close(out.detach().float().cpu().numpy(), want.float().cpu().numpy(),
           2e-2)
    g = torch.randn(out.shape, device=cuda, dtype=dtype)
    got = torch.autograd.grad(out, [x, *ws], g)
    xr = x.detach().requires_grad_()
    wr = [w.detach().requires_grad_() for w in flat]
    ref = torch.autograd.grad(resmlp_plain(xr, wr, 3, **kw), [xr, *wr], g)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_embedding_pallas_trains_every_parameter(cuda, dtype):
    """MVResNetMLPEmbedding(use_pallas=True) on the card, f32 and bf16
    models: both chain halves launch K1', and every parameter gets a
    finite, non-zero gradient that agrees with use_pallas=False at the bf16
    bar (2e-2, relative and x max|ref|): K1' reads bf16 weights and keeps
    an f32 stream."""
    rng = np.random.default_rng(12)
    pos = _tt(rng.normal(size=(4, 32, 16, 3)) * 0.5).to(cuda)
    dirs = _tt(rng.normal(size=(4, 32, 16, 3)) * 0.5).to(cuda)
    feats = _tt(rng.normal(size=(4, 32, 16, 32))).to(cuda)
    grads = []
    for use_pallas in (False, True):
        m = MVResNetMLPEmbedding(32, n_blocks=6, hidden_size=HID, n_views=2,
                                 embed_direction_vector=True,
                                 use_pallas=use_pallas, dtype=dtype).to(cuda)
        init_params(m, torch.Generator(device=cuda).manual_seed(0))
        before = RESMLP.counts["resmlp_rows_diff"]
        torch.mean(m(pos, dirs, feats).float() ** 2).backward()
        torch.cuda.synchronize()
        assert RESMLP.counts["resmlp_rows_diff"] == before + 2 * use_pallas
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name, want in grads[0].items():
        got = grads[1][name]
        assert got is not None and torch.isfinite(got).all(), name
        assert float(got.abs().max()) > 0, name
        _close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


def _tiny_renderer(device, **kw):
    m = MVNeRFRenderer(n_views=1, n_samples=8, n_features=8, near=0.3,
                       far=1.3, original_image_size=(16, 24),
                       fusion="without", n_blocks=2, hidden_size=HID,
                       vit_size=(32, 32), vit_dim=32, vit_heads=2,
                       vit_hooks=(1, 2, 3, 4), corner_gather=False, **kw)
    m = m.to(device)
    init_params(m, torch.Generator(device=device).manual_seed(0))
    return m


def recompute_inputs(device, dtype=torch.float32):
    """A checkpointed chunked loss (the trainer's: draws taken before the
    chunks) on a tiny renderer with pallas_mlp, run forward and backward.
    Returns the fine embedding's inputs per chunk in the forward and in the
    backward's recompute (put back in chunk order: the recompute runs the
    chunks last to first), and the K1' launches of each pass. A chunk that
    drew its own samples would see new ones in the recompute."""
    m = _tiny_renderer(device, pallas_mlp=True, remat=False).to(dtype)
    rng = np.random.default_rng(13)
    b, r = 2, 32
    from tcnerf_torch.data.synthetic import camera_ring
    from tcnerf_torch.core.rays import get_specific_rays
    src_cfg, tgt_cfg = camera_ring(2, height=16, width=24, azimuth_span=0.6)
    ro, rd = get_specific_rays(rng.uniform(0, 23, b * r),
                               rng.uniform(0, 15, b * r), tgt_cfg["pose"],
                               tgt_cfg["intrinsics"].reshape(3, 3))
    k4 = np.eye(4)
    k4[:3, :3] = src_cfg["intrinsics"].reshape(3, 3)
    inputs = tuple(_tt(a, dtype).to(device) for a in (
        ro.reshape(b, r, 3), rd.reshape(b, r, 3),
        rng.uniform(size=(b, 1, 16, 24, 3)), np.tile(k4, (b, 1, 1, 1)),
        np.tile(np.linalg.inv(src_cfg["pose"]), (b, 1, 1, 1))))
    labels = _tt(rng.uniform(size=(b, r, 3)), dtype).to(device)
    draws = tuple(u.to(dtype) for u in training.draw_samples(
        m, b, r, torch.Generator(device=device).manual_seed(1), device))
    seen = {"forward": [], "backward": []}
    phase = ["forward"]
    m.fine_embedding.register_forward_hook(
        lambda mod, args, out: seen[phase[0]].append(args[0].detach().clone()))
    before = RESMLP.counts["resmlp_rows_diff"]
    loss = training.nerf_loss(m, inputs, labels, *draws, ray_chunk=8)
    n_fwd = RESMLP.counts["resmlp_rows_diff"] - before
    phase[0] = "backward"
    loss.backward()
    n_bwd = RESMLP.counts["resmlp_rows_diff"] - before - n_fwd
    assert len(seen["forward"]) == len(seen["backward"]) == r // 8
    assert all(torch.isfinite(p.grad).all() for p in m.parameters())
    return seen["forward"], seen["backward"][::-1], n_fwd, n_bwd


@pytest.mark.gpu
def test_checkpointed_chunk_recompute_uses_the_same_draws(cuda):
    """On the card with K1': the recompute sees the forward's samples bit
    for bit (the same kernels on the same inputs), and launches K1' as
    often as the forward (4 chunks x 2 stages x 2 halves)."""
    fwd, bwd, n_fwd, n_bwd = recompute_inputs(cuda)
    assert all(torch.equal(a, b) for a, b in zip(fwd, bwd))
    assert (n_fwd, n_bwd) == (16, 16)


def _tiny_fused(device, n_views=1, **kw):
    """A tiny CLIP-fused renderer (fusion v0 unless given): 48x64 sources,
    n_features 256, CLIP layers (1, 1, 1, 1), width 8, 32^2, embed 32."""
    m = MVNeRFRenderer(n_views=n_views, n_samples=8, n_features=256,
                       near=0.3, far=1.3, original_image_size=(48, 64),
                       n_blocks=2, hidden_size=HID, vit_size=(32, 32),
                       vit_dim=32, vit_heads=2, vit_hooks=(1, 2, 3, 4),
                       clip_layers=(1, 1, 1, 1), clip_width=8,
                       clip_embed_dim=32, clip_image_size=32,
                       **{"fusion": "v0", **kw})
    init_params(m, torch.Generator().manual_seed(0))
    return m.to(device).eval()


def _fused_scene(device, n_views=1, n_rays=512, seed=14):
    from tcnerf_torch.core.rays import get_specific_rays
    from tcnerf_torch.data.synthetic import camera_ring
    rng = np.random.default_rng(seed)
    cfgs = camera_ring(n_views + 1, height=48, width=64, azimuth_span=0.6)
    k4 = np.tile(np.eye(4), (n_views, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in cfgs[:-1]]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in cfgs[:-1]])
    ro, rd = get_specific_rays(rng.uniform(0, 63, n_rays),
                               rng.uniform(0, 47, n_rays), cfgs[-1]["pose"],
                               cfgs[-1]["intrinsics"].reshape(3, 3))
    src = rng.uniform(size=(1, n_views, 48, 64, 3))
    u_c, u_f = rng.uniform(size=(2, 1, n_rays, 8))
    return tuple(_tt(a).to(device) for a in (ro[None], rd[None], src, k4[None],
                                              ext[None], u_c, u_f))


@pytest.mark.gpu
@pytest.mark.parametrize("fusion", ["v0", "v4"])
def test_fused_combine_features_on_card_matches_cpu(cuda, fusion):
    """combine_features (encoder, preprocess, CLIP tower, fusion) on the
    card against the same code on the CPU: f32 with TF32 off, 1e-4."""
    from tcnerf_torch.core.prec import pin_fp32
    pin_fp32()
    kw = ({"fusion": "v4", "fusion_use_dense": True,
           "fusion_activation": "elu"} if fusion == "v4" else {})
    src = _fused_scene("cpu")[2][0]
    text = torch.randn((1, 32), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want, _ = _tiny_fused("cpu", **kw).combine_features(src, None, text)
        got, _ = _tiny_fused(cuda, **kw).combine_features(
            src.to(cuda), None, text.to(cuda))
    _close(got.cpu().numpy(), want.numpy(), 1e-4)


@pytest.mark.gpu
def test_v0_swg_chunk_kernel_matches_plain(cuda):
    """A v0 model's feature image through swg_prepare and one chunk, K2
    against its plain version at the bf16-prepared chunk bar (rtol 3e-2,
    atol 2e-2)."""
    from tcnerf_torch.models import fused
    m = _tiny_fused(cuda)
    ro, rd, src, k4, ext, u_c, u_f = _fused_scene(cuda)
    before = SWG.counts["swg_head_inside"]
    with torch.inference_mode():
        feats, _ = m.combine_features(src[0])
        prepared = fused.swg_prepare(m, src, feats[None], n_blocks=2,
                                     dtype=torch.bfloat16)
        outs = [fused.swg_render_chunk(prepared, ro, rd, k4, ext, n_samples=8,
                                       n_blocks=2, u_coarse=u_c, u_fine=u_f,
                                       plain=p) for p in (False, True)]
    assert SWG.counts["swg_head_inside"] == before + 2
    for got, want in zip(outs[0][:4], outs[1][:4]):
        assert torch.isfinite(got).all()
        assert torch.allclose(got, want, rtol=3e-2, atol=2e-2)


@pytest.mark.gpu
def test_three_view_chunk_with_k1_matches_plain_chain(cuda):
    """The 3-view v0 model (bf16) on one chunk of `render_rays`: both chain
    halves through K1 (4 launches) against the plain chain on the same
    weights. The coarse pass at the bf16 serving bar (2e-2 x max|ref|);
    the fine pass, whose samples follow the coarse weights through the
    PDF, at the bf16-prepared chunk bar (rtol 3e-2, atol 2e-2)."""
    ro, rd, src, k4, ext, u_c, u_f = _fused_scene(cuda, n_views=3)
    models = [_tiny_fused(cuda, n_views=3, pallas_mlp=p, dtype=torch.bfloat16)
              for p in (True, False)]
    models[1].load_state_dict(models[0].state_dict())
    outs = []
    with torch.inference_mode():
        feats, _ = models[0].combine_features(src[0])
        for m in models:
            before = RESMLP.counts["resmlp_rows"]
            outs.append(m.render_rays(ro, rd, src, k4, ext, feats[None],
                                      u_coarse=u_c, u_fine=u_f))
            launched = RESMLP.counts["resmlp_rows"] - before
            assert launched == (4 if m.pallas_mlp else 0)
    for i, (got, want) in enumerate(zip(*outs)):
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all()
        if i < 2:
            _close(got.cpu().numpy(), want.cpu().numpy(), 2e-2)
        else:
            assert torch.allclose(got, want, rtol=3e-2, atol=2e-2)


# ------------------------------------------------- grasp serving, fused trainers

def _tiny_grasp(device, dtype=torch.float32, **kw):
    """A tiny goal GraspEBM (48x64 sources, n_features 32, 18 probes, 2
    blocks, hidden 32, ViT 32^2), seeded on the CPU, then moved."""
    from tcnerf_torch.models.grasp import GraspEBM
    m = GraspEBM(n_views=1, n_features=32, original_image_size=(48, 64),
                 n_5d_poses=3, n_blocks=2, hidden_size=32, vit_size=(32, 32),
                 vit_dim=32, vit_heads=2, vit_hooks=(1, 2, 3, 4),
                 readout_activation="elu", **kw)
    init_params(m, torch.Generator().manual_seed(0))
    return m.to(device=device, dtype=dtype).eval()


def _grasp_inputs():
    from tcnerf_torch.data.synthetic import camera_ring
    rng = np.random.default_rng(21)
    cfgs = camera_ring(3, height=48, width=64)
    k4 = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in cfgs]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in cfgs], np.float32)
    images = rng.uniform(size=(1, 3, 48, 64, 3)).astype(np.float32)
    return images, k4[None], ext[None]


def _pose_optimizer(model, n=16):
    from tcnerf_torch.opt.pose_optimizer import PoseOptimizer
    return PoseOptimizer(model=model, workspace_bounds=(
        (0.35, 0.85), (-0.25, 0.25), (0.0, 0.2)), n_initial_guesses=n,
        n_images=3, clip_translation=True, init_lr_t=0.05, decay_t=0.9,
        init_lr_r=0.05, decay_r=0.09)


@pytest.mark.gpu
@pytest.mark.parametrize("corner", [True, False])
def test_grasp_energy_and_pose_gradient_on_card_match_cpu(cuda, corner):
    """GraspEBM's features, energies and d(sum E)/d(t, r) of 16 guesses on
    the card against the same model on the CPU (f32, TF32 off): max err
    within 1e-3 x max |cpu|."""
    from tcnerf_torch.core.prec import pin_fp32
    from tcnerf_torch.opt.pose_optimizer import frozen
    pin_fp32()
    images, intr, ext = _grasp_inputs()
    out = []
    for dev in ("cpu", cuda):
        opt = _pose_optimizer(_tiny_grasp(dev, corner_gather=corner))
        with torch.no_grad():
            feats = opt.model.compute_features(torch.as_tensor(images,
                                                               device=dev))
        scene = opt.prepare((images, intr, ext), feats)
        state = opt.init_state(opt.generate_initial_guesses(0))
        t = state.translations.requires_grad_()
        r = state.rotations.requires_grad_()
        with frozen(opt.model):
            e = opt._energies(t, r, scene)
            grads = torch.autograd.grad(e.sum(), [t, r])
        out.append([x.detach().cpu() for x in (feats, e, *grads)])
    for got, want in zip(out[1], out[0]):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-3 * float(
            want.abs().max())


@pytest.mark.gpu
def test_pose_ascent_on_card_matches_cpu_in_f64(cuda):
    """Three synchronized ascent steps of 16 guesses, then the alternating
    `compute_results` schedule, on the card against the CPU in f64 (Adam's
    first step is a sign step, f64 keeps the gradients' signs alike):
    poses within 1e-6, energies within 1e-6 relative."""
    from tcnerf_torch.opt.pose_optimizer import compute_results
    images, intr, ext = _grasp_inputs()
    res = []
    for dev in ("cpu", cuda):
        opt = _pose_optimizer(_tiny_grasp(dev, dtype=torch.float64))
        with torch.no_grad():
            feats = opt.model.compute_features(
                torch.as_tensor(images, dtype=torch.float64, device=dev))
        scene = opt.prepare((images, intr, ext), feats)
        state, trace = opt.optimize_pose(
            opt.init_state(opt.generate_initial_guesses(1)), scene,
            (True, True), 3)
        losses, _, poses, _, _, _ = compute_results(
            opt, (images, intr, ext), feats, n_optimization_steps=2,
            init_lr_t=0.05, decay_t=0.9, init_lr_r=0.05, decay_r=0.09, rng=2)
        res.append((state.translations.cpu(), state.rotations.cpu(),
                    trace.cpu(), torch.as_tensor(losses),
                    torch.as_tensor(np.asarray([p.matrix for p in poses]))))
    for got, want in zip(*res[::-1]):
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-6 * scale


@pytest.mark.gpu
def test_prefetch_to_the_card_keeps_the_batches(cuda):
    """Batches through the side stream equal the host arrays, in order."""
    from tcnerf_torch.data.prefetch import prefetch_to_device
    rng = np.random.default_rng(2)
    host = [((rng.normal(size=(64, 3)).astype(np.float32),),
             rng.normal(size=(5,)).astype(np.float32)) for _ in range(6)]
    got = list(prefetch_to_device(iter(host), cuda, size=2))
    assert len(got) == 6
    for (gi, gl), (hi, hl) in zip(got, host):
        assert gi[0].is_cuda and gl.is_cuda
        np.testing.assert_array_equal(gi[0].cpu().numpy(), hi[0])
        np.testing.assert_array_equal(gl.cpu().numpy(), hl)


@pytest.mark.gpu
def test_fused_train_step_on_card_keeps_the_tower_frozen(cuda):
    """Two train steps of the tiny v0 model with pallas_mlp on the card:
    finite losses, K1' launched (8 per step: 4 forward, 4 in the
    embeddings' remat), every CLIP tower weight bit-identical and without a
    gradient, the nerf group moved."""
    m = _tiny_fused(cuda, pallas_mlp=True, corner_gather=False, remat=True)
    m.train()
    frozen = {n: p.detach().clone() for n, p in m.named_parameters()
              if training.param_group(n) == "frozen"}
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    ro, rd, src, k4, ext, _, _ = _fused_scene(cuda, n_rays=64)
    labels = torch.rand((1, 64, 3), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    state = training.create_train_state(
        m, training.make_nerf_optimizer(m, warmup_steps=1))
    gen = torch.Generator(device=cuda).manual_seed(1)
    n0 = RESMLP.counts["resmlp_rows_diff"]
    for _ in range(2):
        _, metrics = training.nerf_train_step(state, (ro, rd, src, k4, ext),
                                              labels, gen)
        assert np.isfinite(float(metrics["loss"]))
    assert RESMLP.counts["resmlp_rows_diff"] - n0 == 16
    for n, p in m.named_parameters():
        if n in frozen:
            assert p.grad is None and torch.equal(p.detach(), frozen[n]), n
    assert any(not torch.equal(p.detach(), before[n])
               for n, p in m.named_parameters()
               if training.param_group(n) == "nerf")


# ------------------------------------------------------------ grasp training

def _grasp_train_batch(rng, b=1, n=8):
    """A goal batch and a delta-NGF batch (quaternions) for the tiny model:
    (poses, images, intrinsics, extrinsics_inv), one-hot labels; then
    (l_t, l_r, g_t, g_r, images, intrinsics, extrinsics_inv) and
    (one-hot, delta_t, delta_r), numpy f64."""
    from tcnerf_torch.core import se3
    images, intr, ext = _grasp_inputs()
    images, intr, ext = images[:, :1], intr[:, :1], ext[:, :1]
    lo, hi = np.array([0.35, -0.25, 0.0]), np.array([0.85, 0.25, 0.2])

    def poses(k):
        return (rng.uniform(lo, hi, (b, k, 3)), rng.normal(size=(b, k, 4)))

    one_hot = np.zeros((b, n))
    one_hot[:, 0] = 1
    t, r = poses(n)
    mats = se3.pose_to_matrix(torch.as_tensor(t), torch.as_tensor(r)).numpy()
    goal = ([mats, images, intr, ext], one_hot)
    l_t, l_r = poses(n)
    g_t, g_r = poses(n)
    delta = ([l_t, l_r, g_t, g_r, images, intr, ext],
             [one_hot, rng.normal(size=g_t.shape) * 0.01,
              rng.normal(size=g_r.shape) * 0.1])
    return goal, delta


def _grasp_step_grads(model, kind, batch, dev, dtype):
    """The step's metrics and its readout gradients (flat, f64 on the
    CPU)."""
    from tcnerf_torch.models import grasp_training as GT
    m = model.to(device=dev, dtype=dtype)
    state = GT.create_grasp_train_state(m)
    inputs = [torch.as_tensor(x, dtype=dtype, device=dev) for x in batch[0]]
    if kind == "goal":
        labels = torch.as_tensor(batch[1], dtype=dtype, device=dev)
        metrics, grads = GT.grasp_gradients(state, inputs, labels,
                                            "kl_divergence")
    else:
        labels = [torch.as_tensor(x, dtype=dtype, device=dev)
                  for x in batch[1]]
        metrics, grads = GT.delta_ngf_gradients(state, inputs, labels)
    return ({k: float(v) for k, v in metrics.items()},
            torch.cat([g.detach().reshape(-1).cpu().double() for g in grads]))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["goal", "delta"])
def test_grasp_train_step_on_card_matches_cpu(cuda, kind):
    """One grasp_train_step / delta_ngf_train_step of the tiny model on the
    card against the CPU: in f64 the metrics and the readout gradients
    within 1e-8 relative. In f32 (TF32 off) the metrics within 1e-3
    relative, the port's f32 bar: at this size the delta-NGF cosine losses
    are ill-conditioned in f32 (the CPU's own f32 `grad_loss_r` is 3.9e-4
    relative from its f64 one, on the same relu branches); and of the f32
    gradients fewer than 1% of the entries beyond 1e-3 x max |cpu| and the
    median error below 1e-4 x max |cpu|."""
    from tcnerf_torch.core.prec import pin_fp32
    pin_fp32()
    goal, delta = _grasp_train_batch(np.random.default_rng(4))
    _hold_step_against_cpu(cuda, kind, goal if kind == "goal" else delta)


def _hold_step_against_cpu(cuda, kind, batch):
    """The bars of test_grasp_train_step_on_card_matches_cpu for one step
    of the tiny model on `batch`."""
    import copy
    base = _tiny_grasp("cpu")
    for dtype in (torch.float64, torch.float32):
        (mg, gg), (mc, gc) = (_grasp_step_grads(copy.deepcopy(base), kind,
                                                batch, dev, dtype)
                              for dev in (cuda, "cpu"))
        assert torch.isfinite(gg).all()
        tol = 1e-8 if dtype == torch.float64 else 1e-3
        for k, v in mc.items():
            assert abs(mg[k] - v) <= tol * abs(v), (k, mg[k], v)
        scale = float(gc.abs().max())
        err = (gg - gc).abs()
        if dtype == torch.float64:
            assert float(err.max()) <= 1e-8 * scale
        else:
            assert float((err > 1e-3 * scale).double().mean()) < 0.01
            assert float(err.median()) < 1e-4 * scale


@pytest.mark.gpu
def test_goal_step_on_a_collected_dataset_on_card_matches_cpu(cuda,
                                                              tmp_path):
    """One goal step of the tiny model on a batch of a 48x64 dataset
    collected through the task layer (`collect_grasp_dataset`: 2 samples,
    5 perspectives, 3 objects; the goal generator's batch of 2 x 8 poses):
    the card against the CPU with the bars of
    test_grasp_train_step_on_card_matches_cpu, then the step taken on the
    card: a finite loss and the readout trained."""
    from tcnerf_torch.core.prec import pin_fp32
    from tcnerf_torch.data.collect import collect_grasp_dataset
    from tcnerf_torch.data.generators import GraspMVNeRFDataGenerator
    from tcnerf_torch.data.loaders import load_dataset_baseline
    from tcnerf_torch.models import grasp_training as GT
    pin_fp32()
    collect_grasp_dataset(str(tmp_path / "train"), 2, image_size=(48, 64),
                          rng=0)
    generator = GraspMVNeRFDataGenerator(
        load_dataset_baseline(str(tmp_path), 5, "train"),
        workspace_bounds=[[0.35, 0.85], [-0.25, 0.25], [0.0, 0.2]],
        n_views=1, n_points_train=8, batch_size=2, rng=0)
    inputs, labels = generator[0]
    _hold_step_against_cpu(cuda, "goal", (inputs, labels))
    state = GT.create_grasp_train_state(_tiny_grasp(cuda))
    before = [p.detach().clone() for p in state.params]
    _, metrics = GT.grasp_train_step(
        state, [torch.as_tensor(np.asarray(x, np.float32), device=cuda)
                for x in inputs],
        torch.as_tensor(np.asarray(labels, np.float32), device=cuda),
        "kl_divergence")
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    # the energy's last bias has a zero gradient (the softmax ignores a
    # shift), which Adam leaves where it is
    assert any(not torch.equal(p.detach(), b)
               for p, b in zip(state.params, before))


def test_grasp_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    """Each grasp trainer goes to the card: without CUDA it raises before
    touching data, unless the caller passes device="cpu"."""
    from tcnerf_torch.train import (config, train_delta_ngf, train_goal,
                                    train_language, train_trajectory)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, run in (("goal_1_view", train_goal.run_goal_training),
                      ("dngf_1_view", train_delta_ngf.run_delta_training),
                      ("trajectory_1_view-2",
                       train_trajectory.run_trajectory_training),
                      ("language_1_view",
                       train_language.run_language_training)):
        cfg = config.load_config([f"data_dir={tmp_path}"], name)
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg)
        assert not os.path.exists(tmp_path / "storage")
    for main in (train_goal.main, train_delta_ngf.main, train_trajectory.main,
                 train_language.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([f"data_dir={tmp_path}"])


# ------------------------------------------------------------ checkpoints

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_checkpoint_round_trips_card_tensors(cuda, dtype, tmp_path):
    """Every component of the tiny v0 renderer on the card, f32 and bf16:
    `store` writes each leaf in its dtype ("bfloat16" for bf16), and `load`
    into another seeded model on the card brings every tensor back bit
    for bit, in place (the same parameter objects, on the card, in the
    model's dtype); the codec alone round-trips the card's tensors."""
    from tcnerf_torch.models import checkpoint as ckpt
    from tcnerf_torch.models import msgpack_codec
    from tcnerf_torch.params import from_flax, to_flax
    src = _tiny_fused(cuda).to(dtype)
    dst = _tiny_fused("cpu")
    init_params(dst, torch.Generator().manual_seed(7))
    dst = dst.to(device=cuda, dtype=dtype)
    params = {n: p for n, p in dst.named_parameters()}
    path = str(tmp_path / "model_final")
    ckpt.store(path, src, ckpt.RENDERER_COMPONENTS)
    tree = msgpack_codec.read(ckpt.component_path(path, "fine_readout"))
    leaf = tree["output_layer"]["kernel"]
    assert (leaf.dtype == torch.bfloat16 if dtype == torch.bfloat16
            else leaf.dtype == np.float32)
    assert ckpt.load(path, dst, ckpt.RENDERER_COMPONENTS)
    for c in ckpt.RENDERER_COMPONENTS:
        want = getattr(src, c).state_dict()
        for n, t in getattr(dst, c).state_dict().items():
            assert t.is_cuda and t.dtype == dtype, n
            assert torch.equal(t, want[n]), n
    assert all(p is params[n] for n, p in dst.named_parameters())
    again = from_flax(msgpack_codec.loads(msgpack_codec.dumps(
        to_flax(src.visual_features))), dtype=None)
    for n, t in src.visual_features.state_dict().items():
        assert again[n].dtype == dtype and torch.equal(again[n].to(cuda), t)


@pytest.mark.gpu
def test_k1_pack_rebuilt_after_a_load(cuda, tmp_path):
    """An embedding on the K1' path (use_pallas) loads new weights in place:
    its next forward rebuilds the kernel's weight pack (its key reads the
    parameters' versions) and equals a fresh model of the loaded weights."""
    from tcnerf_torch.models import checkpoint as ckpt
    rng = np.random.default_rng(13)
    pos = _tt(rng.normal(size=(4, 32, 16, 3)) * 0.5).to(cuda)
    dirs = _tt(rng.normal(size=(4, 32, 16, 3)) * 0.5).to(cuda)
    feats = _tt(rng.normal(size=(4, 32, 16, 32))).to(cuda)

    def embedding(seed):
        m = MVResNetMLPEmbedding(32, n_blocks=6, hidden_size=HID, n_views=2,
                                 embed_direction_vector=True,
                                 use_pallas=True).to(cuda)
        init_params(m, torch.Generator(device=cuda).manual_seed(seed))
        return m

    holder, other = torch.nn.Module(), torch.nn.Module()
    holder.fine_embedding, other.fine_embedding = embedding(0), embedding(1)
    m = holder.fine_embedding
    with torch.no_grad():
        m(pos, dirs, feats)
        m(pos, dirs, feats)
        assert m.pack_builds == 1
        path = str(tmp_path / "model_final")
        ckpt.store(path, other, ("fine_embedding",))
        assert ckpt.load(path, holder, ("fine_embedding",))
        before = RESMLP.counts["resmlp_rows_diff"]
        got = m(pos, dirs, feats)
        assert m.pack_builds == 2
        assert RESMLP.counts["resmlp_rows_diff"] == before + 2
        want = other.fine_embedding(pos, dirs, feats)
    assert torch.equal(got, want)


# ------------------------------------------------------------- hash grid

HASH_BOUNDS = ((-0.7, 1.7), (-1.2, 1.2), (-0.1, 0.7))


def _hash_points(rng, n):
    """Points in the nerf_convergence_hashgrid box and beyond its faces."""
    lo, hi = np.asarray(HASH_BOUNDS).T
    return rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (n, 3))


@pytest.mark.gpu
def test_hash_encode_on_card_matches_cpu(cuda):
    """hash_encode at the configs' width (16 levels of 2^14 x 2) on 200,000
    points on the card against the CPU: the same table rows (the scales are
    the CPU's f32 bits, the hash int64 on both), so the encoding within
    1e-6 x max and its gradients in the points and the tables within
    1e-5 x max."""
    from tcnerf_torch.device import resolve_device
    from tcnerf_torch.ops.hashgrid import HashGridConfig, hash_encode
    resolve_device("cuda")
    rng = np.random.default_rng(21)
    cfg = HashGridConfig(bounds=HASH_BOUNDS)
    tables = _tt(rng.uniform(-1, 1, (16, 2 ** 14, 2)))
    x = _tt(_hash_points(rng, 200_000))
    w = _tt(rng.normal(size=(200_000, 32)))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t = tables.to(dev).requires_grad_()
        p = x.to(dev).requires_grad_()
        enc = hash_encode(t, p, cfg)
        grads = torch.autograd.grad((enc * w.to(dev)).sum(), (t, p))
        outs.append([a.detach().cpu() for a in (enc,) + grads])
    for (got, want), tol in zip(zip(*outs), (1e-6, 1e-5, 1e-5)):
        _close(got.numpy(), want.numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_hashgrid_field_on_card_matches_cpu(cuda, dtype):
    """HashGridField at the configs' width (16 x 2^14 x 2 tables, 3 layers
    of 64) on 65,536 points, card vs CPU with TF32 off: f32 1e-3, bf16
    2e-2."""
    from tcnerf_torch.device import resolve_device
    from tcnerf_torch.nn.hashgrid_field import HashGridField
    resolve_device("cuda")
    rng = np.random.default_rng(22)
    m = HashGridField(bounds=HASH_BOUNDS, dtype=dtype)
    init_params(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.hash_tables.mul_(1e4)        # features of the MLP's scale
    x = _tt(_hash_points(rng, 65_536)).reshape(64, 1024, 3)
    d = _tt(rng.normal(size=(64, 1024, 3)))
    with torch.no_grad():
        want = m(x, d).float()
        got = m.to(cuda)(x.to(cuda), d.to(cuda)).float().cpu()
    _close(got.numpy(), want.numpy(), 1e-3 if dtype == torch.float32
           else 2e-2)


@pytest.mark.gpu
def test_sharded_render_world1_nccl_matches_render_all_rays(cuda):
    """parallel/serve.py on the card: make_mesh(1) forms a world-1 NCCL
    group, and render_image_sharded of a tiny bf16 1-view model (hidden
    128, pallas_mlp: K1 in both chain halves) equals render_all_rays with
    the same generator seed bit for bit, with as many K1 launches."""
    import torch.distributed as dist
    from tcnerf_torch.data.synthetic import camera_ring
    from tcnerf_torch.models.inference import render_all_rays
    from tcnerf_torch.parallel.mesh import destroy_mesh, make_mesh
    from tcnerf_torch.parallel.serve import render_image_sharded
    h, w = 32, 40
    model = MVNeRFRenderer(
        n_views=1, n_samples=8, n_features=8, near=0.3, far=1.3,
        original_image_size=(h, w), fusion="without", n_blocks=2,
        hidden_size=HID, vit_size=(32, 32), vit_dim=32, vit_heads=2,
        vit_hooks=(1, 2, 3, 4), pallas_mlp=True, dtype=torch.bfloat16)
    model = model.to(cuda).eval()
    init_params(model, torch.Generator(device=cuda).manual_seed(0))
    src_cfg, tgt_cfg = camera_ring(2, height=h, width=w)
    k4 = np.eye(4, dtype=np.float32)
    k4[:3, :3] = src_cfg["intrinsics"].reshape(3, 3)
    rng = np.random.default_rng(23)
    args = (model, _tt(rng.uniform(size=(1, 1, h, w, 3))).to(cuda),
            _tt(k4[None, None]).to(cuda),
            _tt(np.linalg.inv(src_cfg["pose"])[None, None]).to(cuda),
            _tt(rng.normal(size=(1, 1, h, w, 8)), torch.bfloat16).to(cuda),
            _tt(tgt_cfg["pose"]).to(cuda),
            _tt(tgt_cfg["intrinsics"].reshape(3, 3)).to(cuda), h, w, 256)
    mesh = make_mesh(1)
    try:
        assert dist.get_backend() == "nccl"
        outs, launches = [], []
        for render in (functools.partial(render_image_sharded, mesh),
                       render_all_rays):
            RESMLP.counts.clear()
            with torch.no_grad():
                outs.append(render(*args, generator=torch.Generator(
                    device=cuda).manual_seed(3)))
            torch.cuda.synchronize()
            launches.append(RESMLP.counts.get("resmlp_rows", 0))
    finally:
        destroy_mesh()
    assert launches[0] == launches[1] > 0
    for got, want in zip(*outs):
        assert torch.equal(got, want)


# ----------------------------------------------------------- probe chain

def _probe_scene(dev, h, w, n_features, n_images=3, seed=31):
    """Cameras of a ring around the workspace and seeded images and
    features [1, n_images, h, w, .] on `dev`."""
    from tcnerf_torch.data.synthetic import camera_ring
    cfgs = camera_ring(n_images, height=h, width=w)
    k4 = np.tile(np.eye(4, dtype=np.float32), (n_images, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in cfgs]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in cfgs], np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand((1, n_images, h, w, 3), generator=gen, device=dev)
    feats = torch.randn((1, n_images, h, w, n_features), generator=gen,
                        device=dev)
    return (images.cpu().numpy(), k4[None], ext[None]), feats


def _draw_probe_biases(model, dev):
    """Seeded biases for the Dense layers of the chain and the readout,
    those the kernels read among them (the initializers leave them
    zero)."""
    from tcnerf_torch.nn.layers import Dense
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for m in (*model.fine_embedding.modules(),
                  *model.grasp_readout.modules()):
            if isinstance(m, Dense) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen,
                                         device=dev) * 0.1)


def _config_grasp(dev, name):
    """The config's GraspEBM at its widths (hidden 128, 6 blocks, n_features
    256, 42 probes, 480x640) on the card, seeded; the encoder towers are
    built but the tests hand `prepare` seeded features."""
    from tcnerf_torch.train.config import load_config
    from tcnerf_torch.train.grasp_common import build_grasp_model
    cfg = load_config([], name)
    model = build_grasp_model(cfg, fusion="v4" if name.startswith(
        "language") else None, device=dev).eval()
    _draw_probe_biases(model, dev)
    return model, cfg


def _probe_optimizer(model, cfg, n, n_images=None):
    from tcnerf_torch.opt.pose_optimizer import PoseOptimizer
    oc = cfg.validation.grasp_opt_config
    sc = oc.optimization_config
    return PoseOptimizer(
        model=model, workspace_bounds=cfg.generator_grasp.workspace_bounds,
        n_initial_guesses=n,
        n_images=n_images or oc.optimizer_config.n_images,
        n_views=model.n_views,
        rotation_representation=cfg.grasp_model.get(
            "rotation_representation", "quaternion"),
        clip_translation=oc.optimizer_config.clip_translation,
        init_lr_t=sc.init_lr_t, decay_t=sc.decay_t, init_lr_r=sc.init_lr_r,
        decay_r=sc.decay_r)


def _plain_path(monkeypatch):
    """Make `energy_prepared` take its plain path whatever it is given."""
    from tcnerf_torch.models.grasp import GraspEBM
    monkeypatch.setattr(GraspEBM, "probe_kernel_engages",
                        lambda self, poses, prepared: False)


def _energy_and_grads(opt, scene, guesses, train=(True, True)):
    from tcnerf_torch.opt.pose_optimizer import frozen
    state = opt.init_state(guesses)
    t = state.translations.requires_grad_(train[0])
    r = state.rotations.requires_grad_(train[1])
    with frozen(opt.model):
        e = opt._energies(t, r, scene)
        grads = torch.autograd.grad(
            e.sum(), [x for x, on in zip((t, r), train) if on])
    return [x.detach() for x in (e, *grads)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["goal_1_view", "language_1_view"])
def test_probe_kernels_energy_and_pose_gradient_match_plain(cuda, name,
                                                            monkeypatch):
    """At the config's widths, 3 images of 480x640 and 512 guesses
    (64,512 probe rows): energies and d(sum E)/d(t, r) through the probe
    kernels against the plain path on the same card (f32, TF32 off),
    within 1e-4 (energies) and 1e-3 (gradients) of the largest |plain|;
    one forward and one backward launch."""
    from tcnerf_torch.core.prec import pin_fp32
    from tcnerf_torch.ops.probe import PROBE
    pin_fp32()
    model, cfg = _config_grasp(cuda, name)
    opt = _probe_optimizer(model, cfg, 512)
    inputs, feats = _probe_scene(cuda, 480, 640, model.n_features)
    scene = opt.prepare(inputs, feats)
    guesses = opt.generate_initial_guesses(7)
    before = dict(PROBE.counts)
    got = _energy_and_grads(opt, scene, guesses)
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in PROBE.counts.items()}
    _plain_path(monkeypatch)
    want = _energy_and_grads(opt, scene, guesses)
    assert launched == {"probe_fwd": 1, "probe_bwd": 1}
    for g, w, tol in zip(got, want, (1e-4, 1e-3, 1e-3)):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["goal_1_view", "language_1_view"])
def test_probe_kernels_ascent_matches_plain(cuda, name, monkeypatch):
    """16 synchronised ascent steps of 512 guesses and the final energies:
    the median over guesses of |kernels - plain| over the plain energies'
    spread within the benchmark's `energy_gap_median` limit (5e-4); 33
    launches (16 forward and backward, and the final energies' forward)."""
    from tcnerf_torch.core.prec import pin_fp32
    from tcnerf_torch.ops.probe import PROBE
    pin_fp32()
    model, cfg = _config_grasp(cuda, name)
    opt = _probe_optimizer(model, cfg, 512)
    inputs, feats = _probe_scene(cuda, 480, 640, model.n_features)
    scene = opt.prepare(inputs, feats)
    guesses = opt.generate_initial_guesses(11)
    finals = []
    for plain in (False, True):
        if plain:
            _plain_path(monkeypatch)
        before = sum(PROBE.counts.values())
        opt.reset_optimizer()
        state, _ = opt.optimize_pose(opt.init_state(guesses), scene,
                                     (True, True), 16)
        finals.append(opt.compute_current_grasp_success(state, scene))
        torch.cuda.synchronize()
        assert sum(PROBE.counts.values()) - before == (0 if plain else 33)
    got, want = (x.double().cpu() for x in finals)
    gap = (got - want).abs() / want.std()
    assert torch.isfinite(got).all()
    assert float(gap.median()) <= 5e-4


def _small_probe_grasp(dev, **kw):
    """A GraspEBM the kernels fit (hidden 128, 6 blocks, 42 probes) at
    48x64 with a small feature width, seeded."""
    from tcnerf_torch.models.grasp import GraspEBM
    m = GraspEBM(n_features=32, original_image_size=(48, 64), n_5d_poses=7,
                 n_blocks=6, hidden_size=HID, vit_size=(32, 32), vit_dim=32,
                 vit_heads=2, vit_hooks=(1, 2, 3, 4),
                 readout_activation="elu", **kw)
    init_params(m, torch.Generator().manual_seed(0))
    m = m.to(dev).eval()
    _draw_probe_biases(m, dev)
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f64", "trainable", "hash_encoding",
                                  "no_corner_gather", "two_views",
                                  "corner_grad"])
def test_probe_kernels_fall_back_bit_for_bit(cuda, case, monkeypatch):
    """Where a condition of the dispatch fails, `energy_prepared` launches
    nothing and gives the plain path's energies and pose gradients bit for
    bit."""
    from tcnerf_torch.ops.probe import PROBE
    from tcnerf_torch.train.config import load_config
    kw = {"hash_encoding": dict(hash_encoding=True),
          "no_corner_gather": dict(corner_gather=False),
          "two_views": dict(n_views=2)}.get(case, {})
    model = _small_probe_grasp(cuda, **kw)
    if case == "f64":
        model = model.double()
    n_images = 4 if case == "two_views" else 3
    opt = _probe_optimizer(model, load_config([], "goal_1_view"), 16, n_images)
    inputs, feats = _probe_scene(cuda, 48, 64, 32, n_images)
    scene = opt.prepare(inputs, feats.to(opt.dtype))
    if case == "corner_grad":
        # a caller that differentiates through the features
        scene.prepared.corner.requires_grad_()
    guesses = opt.generate_initial_guesses(3)
    if case == "trainable":
        # grad mode on and the weights trainable: the grasp trainers' case
        state = opt.init_state(guesses)
        t = state.translations.requires_grad_()
        r = state.rotations.requires_grad_()

        def run():
            e = opt._energies(t, r, scene)
            return [x.detach() for x in (e, *torch.autograd.grad(e.sum(),
                                                                 [t, r]))]
    else:
        def run():
            return _energy_and_grads(opt, scene, guesses)
    before = dict(PROBE.counts)
    got = run()
    assert dict(PROBE.counts) == before
    _plain_path(monkeypatch)
    for g, w in zip(got, run()):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_probe_kernels_follow_an_in_place_update(cuda, monkeypatch):
    """A trainer updates the weights in place between its validation
    ascents: the kernels' energies after such an update are the plain
    path's (within 1e-4 of the largest), not the old weights'."""
    from tcnerf_torch.core.prec import pin_fp32
    from tcnerf_torch.ops.probe import PROBE
    from tcnerf_torch.train.config import load_config
    pin_fp32()
    model = _small_probe_grasp(cuda)
    opt = _probe_optimizer(model, load_config([], "goal_1_view"), 64)
    inputs, feats = _probe_scene(cuda, 48, 64, 32)
    scene = opt.prepare(inputs, feats)
    state = opt.init_state(opt.generate_initial_guesses(4))
    before = opt.compute_current_grasp_success(state, scene)
    with torch.no_grad():
        for p in model.probe_weights().params():
            p.mul_(1.25)
    n = sum(PROBE.counts.values())
    got = opt.compute_current_grasp_success(state, scene)
    assert sum(PROBE.counts.values()) == n + 1
    _plain_path(monkeypatch)
    want = opt.compute_current_grasp_success(state, scene)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert float((before - want).abs().max()) > 1e-2 * scale
