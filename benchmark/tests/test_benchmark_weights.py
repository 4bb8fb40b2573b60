"""The benchmark's seeded weights: every parameter drawn from the seed, no
bias zero and no norm scale one, the same tensors for two models with the
same names and shapes, and other tensors for another seed."""

import torch

from benchmark.lib import weights

SHAPES = [("enc.conv.weight", (8, 3, 3, 3)), ("enc.conv.bias", (8,)),
          ("mlp.layer_0.weight", (16, 32)), ("mlp.layer_0.bias", (16,)),
          ("norm.scale", (16,)), ("norm.bias", (16,)),
          ("vit.pos_embedding", (1, 5, 16))]


def test_every_parameter_is_drawn():
    w = weights.make_weights(SHAPES, 2 ** 31 + 5, "cpu")
    assert set(w) == {n for n, _ in SHAPES}
    for name, shape in SHAPES:
        assert tuple(w[name].shape) == shape
        assert w[name].std() > 0, name
    assert (w["norm.scale"] - 1).abs().max() <= 0.1
    assert (w["norm.scale"] - 1).abs().max() > 0.01
    assert w["norm.bias"].abs().max() <= 0.1
    assert w["mlp.layer_0.bias"].abs().max() <= 32 ** -0.5
    assert w["enc.conv.bias"].abs().max() <= 27 ** -0.5
    var = w["mlp.layer_0.weight"].var().item()
    assert 0.5 / 32 < var < 2 / 32


def test_same_seed_same_weights():
    a = weights.make_weights(SHAPES, 7, "cpu")
    b = weights.make_weights(list(reversed(SHAPES)), 7, "cpu")
    c = weights.make_weights(SHAPES, 8, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["mlp.layer_0.bias"], c["mlp.layer_0.bias"])
