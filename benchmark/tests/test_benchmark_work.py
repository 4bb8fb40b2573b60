"""The arithmetic the shares are read against, held to hand counts at two
shapes each."""

import pytest
import torch

from benchmark.lib import peaks
from benchmark.lib import work
from benchmark.reference.encoder import Block
from benchmark.reference.field import Embedding


@pytest.mark.parametrize("hidden,blocks,want", [(128, 6, 424_960),
                                                (32, 2, 16_128)])
def test_chain_query_flops(hidden, blocks, want):
    # head 120 -> hidden, 2 * blocks hidden x hidden layers, readout -> 4
    assert work.chain_query_flops(hidden, blocks) == want


@pytest.mark.parametrize("shape,want", [
    ((480, 640, 64, 128, 6), (58_982_400 * 424_960, 2_988_441_600)),
    ((48, 64, 8, 32, 2), (1_189_085_184, 3_932_160))])
def test_chunk_work(shape, want):
    got = work.chunk_work(*shape)
    assert (got["flops"], got["bytes"]) == (float(want[0]), float(want[1]))


@pytest.mark.parametrize("lead,rows", [((1, 5, 2), 10), ((2, 3, 4), 24)])
def test_counted_embedding(lead, rows):
    # layer_0 (120 + 35) -> 32, then 2 blocks of two 32 x 32 layers
    with torch.device("meta"):
        emb = Embedding(35, 2, 32, 1)
        pos = torch.empty(lead + (3,))
        feats = torch.empty(lead + (35,))
    got = work.counted_flops(lambda: emb(pos, pos, feats))
    assert got == rows * (2 * 155 * 32 + 4 * 2 * 32 * 32)


@pytest.mark.parametrize("b,t,d,want", [(1, 197, 768, 2_907_909_120),
                                        (2, 5, 16, 64_640)])
def test_counted_vit_block(b, t, d, want):
    # q, k, v, out: 8 b t d^2; scores and mix: 4 b t^2 d; MLP: 16 b t d^2
    with torch.device("meta"):
        block = Block(d, 4)
        x = torch.empty((b, t, d))
    assert work.counted_flops(lambda: block(x)) == want


def test_peaks():
    assert peaks.bound_ms(989e12, 0) == (1000.0, "operations")
    assert peaks.bound_ms(0, 3.35e12) == (1000.0, "bytes")
    assert peaks.bound_ms(67e12, 0, "float32")[0] == 1000.0
    assert peaks.least_ms({"float32": 67e12, "bfloat16": 989e12}) == 2000.0
