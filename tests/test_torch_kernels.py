"""tcnerf_torch kernel modules (ops/resmlp.py, ops/swg.py) against the JAX
Pallas kernels in interpret mode. The CUDA kernels against their plain
versions on the card are in test_torch_gpu.py, which also holds the input
helpers (it imports no JAX).

Inputs are made with numpy from a seed and fed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcnerf.ops.pallas.resmlp import resmlp_rows as jax_resmlp_rows
from tcnerf.ops.pallas.swg import prepare_image, swg_rows
from tcnerf_torch.ops.resmlp import RESMLP, resmlp_plain, resmlp_rows
from tcnerf_torch.ops.swg import (SWG, encode_head, swg_field_plain,
                                  swg_field_rows)
from test_torch_gpu import RESMLP_CASES, _chain, _close, _swg_inputs, _tt

HID = 128


@pytest.mark.parametrize("readout,skip_input,fast", RESMLP_CASES)
def test_resmlp_plain_matches_pallas(readout, skip_input, fast):
    """resmlp_plain == resmlp_rows(interpret=True): f32 weights in f32 mode
    (1e-3, the JAX suite's f32 bar; only summation order differs), bf16
    weights and stream in fast mode (2e-2 x max|ref|, the bf16 serving bar:
    bf16 rounds at every layer on both sides, not always to the same bit)."""
    rng = np.random.default_rng(0)
    n_blocks, d_in = 2, (None if skip_input else 40)
    flat = _chain(rng, n_blocks, d_in, 4 if readout else None)
    x = rng.normal(size=(200, HID if skip_input else d_in)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if fast else (jnp.float32,
                                                            torch.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_resmlp_rows(jnp.asarray(x, jdt),
                               tuple(jnp.asarray(w, jdt) for w in flat),
                               n_blocks, readout=readout, tile=64,
                               interpret=True, skip_input=skip_input,
                               fast=fast)
    got = resmlp_plain(_tt(x, tdt), [_tt(w, tdt) for w in flat], n_blocks,
                       readout=readout, skip_input=skip_input, fast=fast)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           2e-2 if fast else 1e-3)


def test_resmlp_rows_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    flat = [_tt(w) for w in _chain(rng, 1, None, 4)]
    x = _tt(rng.normal(size=(33, HID)))
    before = RESMLP.counts["resmlp_rows"]
    got = resmlp_rows(x, flat, 1, readout=True, skip_input=True)
    want = resmlp_plain(x, flat, 1, readout=True, skip_input=True)
    assert torch.equal(got, want)
    assert RESMLP.counts["resmlp_rows"] == before   # no kernel launched


@pytest.mark.parametrize("fast", [False, True])
def test_swg_field_plain_matches_pallas(fast):
    """swg_field_plain == swg_rows(interpret=True). f32 path: 1e-3 (the JAX
    suite's bar, test_kernels.py:531; double-angle octaves on both sides).
    fast path: 2e-2 x max|ref| (test_kernels.py:530-533) — the TPU kernel
    quantises the lerp fractions to 11 bits and, in bf16, rounds the
    triangle weights, while the port lerps exactly in f32. Both in f32: the
    interpreted TPU kernel's bf16 x bf16 -> f32 dot does not run on the
    CPU backend."""
    rng = np.random.default_rng(2)
    n, n_blocks, h, w = 512, 2, 16, 24
    img, coords, pos, dirs, head_k, head_b, flat = _swg_inputs(
        rng, n, h, w, margin=0.0 if fast else 2.0)
    jdt, tdt = jnp.float32, torch.float32
    grouped, w_pad, w_groups = prepare_image(jnp.asarray(img, jdt), ka=4)
    with jax.default_matmul_precision("highest"):
        want, ov = swg_rows(grouped, w_pad, w_groups, w, h, jnp.asarray(coords),
                            jnp.asarray(pos), jnp.asarray(dirs),
                            jnp.asarray(head_k), jnp.asarray(head_b),
                            tuple(jnp.asarray(x, jdt) for x in flat), n_blocks,
                            ka=4, bq=512, fast=fast, interpret=True)
    assert not bool(ov)
    tflat = [_tt(x, tdt) for x in flat]
    if fast:
        got = swg_field_plain(_tt(img, tdt), _tt(coords), _tt(pos), _tt(dirs),
                              tflat, n_blocks, _tt(head_k), _tt(head_b),
                              fast=True)
    else:
        h0 = encode_head(_tt(pos), _tt(dirs), _tt(head_k), _tt(head_b), tdt)
        got = swg_field_plain(_tt(img, tdt), _tt(coords), None, None, tflat,
                              n_blocks, h0_geo=h0, fast=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, 4)
    _close(got.numpy(), np.asarray(want), 2e-2 if fast else 1e-3)


def test_swg_field_rows_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    img, coords, pos, dirs, head_k, head_b, flat = _swg_inputs(rng, 40)
    args = (_tt(img), _tt(coords), _tt(pos), _tt(dirs), [_tt(x) for x in flat],
            2, _tt(head_k), _tt(head_b))
    before = sum(SWG.counts.values())
    assert torch.equal(swg_field_rows(*args), swg_field_plain(*args))
    assert sum(SWG.counts.values()) == before
