"""The chain kernels' host-side weight layout (ops/resmlp.py, ops/swg.py),
on the CPU: the swizzled ring entries the kernels stream must unpack to
the original `[out][in]` weights and biases bit for bit, so a layout fault
shows here and not only on the card."""

import numpy as np
import pytest
import torch

from tcnerf_torch.nn.mlp import MVResNetMLPEmbedding
from tcnerf_torch.ops.resmlp import (HIDDEN, LAYER_BYTES, STAGE_BYTES,
                                     pack_chain, swizzle_index)
from tcnerf_torch.ops.swg import head_permutation, pack_swg

from test_torch_gpu import _chain, _tt


def unpack_ring(ring):
    """Ring entries -> ([L, 128, 128] bf16 [out][in], [L, 128] f32): the
    inverse of the packing, read back through `swizzle_index`."""
    w = ring[:, :LAYER_BYTES].contiguous().view(torch.bfloat16)
    b = ring[:, LAYER_BYTES:].contiguous().view(torch.float32)
    return w[:, swizzle_index(HIDDEN).reshape(-1)].reshape(-1, HIDDEN, HIDDEN), b


@pytest.mark.parametrize("rows", [64, 128])
def test_swizzle_index_is_the_wgmma_128b_layout(rows):
    """Element (m, k) sits in 64-column half k // 64, row m of 128 bytes,
    16-byte chunk ((k % 64) // 8) ^ (m % 8), slot k % 8; the map is a
    bijection onto the tile."""
    pos = swizzle_index(rows).numpy()
    assert sorted(pos.reshape(-1)) == list(range(rows * HIDDEN))
    m, k = np.meshgrid(np.arange(rows), np.arange(HIDDEN), indexing="ij")
    byte = 2 * pos
    half, within = np.divmod(byte, rows * 128)
    row, in_row = np.divmod(within, 128)
    chunk, in_chunk = np.divmod(in_row, 16)
    assert (half == k // 64).all() and (row == m).all()
    assert ((chunk ^ (m % 8)) == (k % 64) // 8).all()
    assert (in_chunk == 2 * (k % 8)).all()


@pytest.mark.parametrize("n_blocks,d_in,readout", [
    (3, None, False), (0, None, True), (2, 379, True), (1, 128, False)])
def test_pack_chain_unpacks_to_the_weights(n_blocks, d_in, readout):
    """Ring entries: the input Dense's 128-wide k-chunks of W0^T (zero past
    d_in, b0 with the last), then each block's two layers, transposed to
    [out][in]; the readout beside the ring."""
    rng = np.random.default_rng(11)
    flat = [_tt(w, torch.bfloat16)
            for w in _chain(rng, n_blocks, d_in, 4 if readout else None)]
    pack = pack_chain(flat, n_blocks, readout=readout,
                      skip_input=d_in is None)
    n_pre = 0 if d_in is None else -(-d_in // HIDDEN)
    assert pack.ring.dtype == torch.uint8
    assert pack.ring.shape == (max(n_pre + 2 * n_blocks, 1), STAGE_BYTES)
    if n_pre + 2 * n_blocks == 0:
        assert not pack.ring.any()
    else:
        mats, biases = unpack_ring(pack.ring)
        want_m, want_b = [], []
        if d_in is not None:
            w0t = torch.zeros((HIDDEN, n_pre * HIDDEN), dtype=torch.bfloat16)
            w0t[:, :d_in] = flat[0].t()
            want_m += list(w0t.split(HIDDEN, 1))
            want_b += [torch.zeros(HIDDEN)] * (n_pre - 1) + [flat[1].float()]
        idx = 0 if d_in is None else 2
        for i in range(n_blocks):
            wa, ba, wb, bb = flat[idx + 4 * i: idx + 4 * i + 4]
            want_m += [wa.t(), wb.t()]
            want_b += [ba.float(), bb.float()]
        assert torch.equal(mats, torch.stack(want_m))
        assert torch.equal(biases, torch.stack(want_b))
    if readout:
        assert torch.equal(pack.wro, flat[-2].t())
        assert torch.equal(pack.bro, flat[-1].float())
    else:
        assert pack.wro is None and pack.bro is None


def test_pack_swg_puts_the_permuted_head_first():
    """Entry 0: head_k's rows in the kernel's encoding-column order, zero
    past 12 * n_freq, with head_b; then the chain layers."""
    rng = np.random.default_rng(12)
    n_freq = 10
    flat = [_tt(w, torch.bfloat16) for w in _chain(rng, 2, None, 4)]
    head_k = _tt(rng.normal(size=(12 * n_freq, HIDDEN)))
    head_b = _tt(rng.normal(size=(HIDDEN,)))
    pack = pack_swg(flat, 2, head_k, head_b, n_freq)
    mats, biases = unpack_ring(pack.ring)
    perm = head_permutation(n_freq)
    head_t = mats[0].float()
    for j in (0, 1, 59, 60, 119):
        assert torch.equal(head_t[:, j], head_k[perm[j]].to(torch.bfloat16).float())
    assert not head_t[:, 12 * n_freq:].any()
    assert torch.equal(biases[0], head_b)
    assert torch.equal(mats[1:], torch.stack([flat[0].t(), flat[2].t(),
                                              flat[4].t(), flat[6].t()]))
    assert torch.equal(pack.wro, flat[-2].t())
    headless, _ = unpack_ring(pack_swg(flat, 2).ring)
    assert not headless[0].any() and torch.equal(headless[1:], mats[1:])


def test_mlp_chain_packs_are_built_once_per_weights_version():
    """The flax path's per-module packs are reused across calls and rebuilt
    when a parameter changes in place."""
    mlp = MVResNetMLPEmbedding(32, n_blocks=2, hidden_size=HIDDEN, n_views=1,
                               dtype=torch.bfloat16).to(torch.bfloat16)
    dt = torch.bfloat16

    def packs():
        return mlp._chain_packs([mlp._chain_flat(mlp.feature_blocks, dt),
                                 mlp._chain_flat(mlp.fusion_blocks, dt)], dt)

    first = packs()
    assert packs() is first
    with torch.no_grad():
        mlp.fusion_blocks[0].layer_1.bias.add_(1.0)
    second = packs()
    assert second is not first
    _, biases = unpack_ring(second[1].ring)
    assert torch.equal(biases[1], mlp.fusion_blocks[0].layer_1.bias.float())
