"""tcnerf_torch gather probes (ops/gather.py, tools/bench_gather{2,3,4}.py)
against the TPU gather probes K4-K13 in tools/bench_gather{2,3,4}.py, which
run here in Pallas's TPU interpret mode. The CUDA kernels against their plain
versions on the card are in test_torch_gpu.py.

Inputs are made with numpy from a seed and fed to both sides; bf16 inputs
are drawn as f32 values that bf16 holds exactly, so both sides start from
the same bits. A gather moves bits, so the bar is bit equality.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tcnerf_torch.ops import gather as G
from tcnerf_torch.tools import bench_gather2, bench_gather3, bench_gather4
from tcnerf_torch.tools.common import bound_ms

ROOT = Path(__file__).resolve().parent.parent
N = 1024             # two of the probes' 512-query tiles


@functools.lru_cache(maxsize=None)
def _jax_tool(name):
    """tools/<name>.py (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf(a):
    """f32 values that bf16 holds exactly."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t.float().numpy()


def _normal(rng, shape, dt):
    a = rng.normal(size=shape).astype(np.float32)
    return (_bf(a) if dt == "bf16" else a), dt


def _ints(rng, hi, shape):
    """Indices in [0, hi), the first and the last among them."""
    a = rng.integers(0, hi, size=shape).astype(np.int32)
    a.reshape(-1)[:2] = (0, hi - 1)
    return a, "i32"


def _periodic(rng, hi):
    """Indices with period 512: the TPU row-loop probes read them with the
    tile-local index, which only then equals the intended gather."""
    return np.tile(_ints(rng, hi, 512)[0], N // 512), "i32"


_JNP = {"bf16": jnp.bfloat16, "f32": jnp.float32, "i32": jnp.int32}
_TORCH = {"bf16": torch.bfloat16, "f32": torch.float32, "i32": torch.int32}

# K -> (tool, JAX probe, port wrapper, inputs(rng) -> [(array, dtype)])
CASES = {
    "K4": ("bench_gather2", "pallas_dma_gather", G.gather_rows,
           lambda r: [_normal(r, (3000, 512), "bf16"), _ints(r, 3000, N)]),
    "K5": ("bench_gather2", "pallas_vmem_loop", G.gather_rows_window,
           lambda r: [_normal(r, (2048, 512), "bf16"), _ints(r, 2048, N)]),
    "K6": ("bench_gather2", "pallas_vmem_take", G.gather_rows_window,
           lambda r: [_normal(r, (2048, 512), "bf16"), _ints(r, 2048, N)]),
    "K7-f32": ("bench_gather3", "pallas_row_loop", G.gather_rows_window,
               lambda r: [_normal(r, (2048, 128), "f32"), _periodic(r, 2048)]),
    "K7-bf16": ("bench_gather3", "pallas_row_loop", G.gather_rows_window,
                lambda r: [_normal(r, (2048, 128), "bf16"),
                           _periodic(r, 2048)]),
    "K8": ("bench_gather3", "pallas_lane_gather", G.gather_lanes,
           lambda r: [_normal(r, (N, 128), "bf16"), _ints(r, 128, (N, 128))]),
    "K9": ("bench_gather3", "pallas_onehot", G.gather_onehot,
           lambda r: [_normal(r, (512, 128), "bf16"), _ints(r, 512, (N, 1))]),
    "K10": ("bench_gather4", "pallas_row_loop", G.gather_rows_window,
            lambda r: [_normal(r, (2048, 128), "bf16"), _periodic(r, 2048)]),
    "K11": ("bench_gather4", "pallas_lane", G.gather_lanes,
            lambda r: [_normal(r, (N, 128), "bf16"), _ints(r, 128, (N, 128))]),
    "K12": ("bench_gather4", "pallas_lane_f32", G.gather_lanes,
            lambda r: [_normal(r, (N, 128), "f32"), _ints(r, 128, (N, 128))]),
    "K13": ("bench_gather4", "pallas_onehot", G.gather_onehot,
            lambda r: [_normal(r, (2048, 128), "bf16"), _ints(r, 2048, (N, 1))]),
}


def _run_jax(tool, fn, args):
    with pltpu.force_tpu_interpret_mode():
        out = getattr(_jax_tool(tool), fn)(
            *(jnp.asarray(a, _JNP[dt]) for a, dt in args))
        return np.asarray(out.astype(jnp.float32))


def _run_port(wrapper, args):
    before = dict(G.GATHER.counts)
    out = wrapper(*(torch.from_numpy(a).to(_TORCH[dt]) for a, dt in args))
    assert dict(G.GATHER.counts) == before      # the CPU path launches nothing
    assert out.dtype == _TORCH[args[0][1]]
    return out.float().numpy()


@pytest.mark.parametrize("k", sorted(CASES, key=lambda k: int(k[1:].split("-")[0])))
def test_port_matches_tpu_probe(k):
    """The port's wrapper (plain version on the CPU) == the TPU probe in
    interpret mode, bit for bit, at N = 1024 (C = 512 for bench_gather2,
    whose block shapes fix it)."""
    tool, fn, wrapper, make = CASES[k]
    args = make(np.random.default_rng(int(k[1:].split("-")[0])))
    want = _run_jax(tool, fn, args)
    got = _run_port(wrapper, args)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tool", ["bench_gather3", "bench_gather4"])
def test_tpu_row_loop_reads_tile_local_indices(tool):
    """An edge of the reference (K7, K10): `pallas_row_loop` prefetches the
    whole index array but reads idx_ref[q] with the tile-local q, so every
    512-query tile gathers the rows of the first 512 indices. The port
    computes the intended gather out[q] = win[idx[q]]."""
    rng = np.random.default_rng(13)
    win, _ = _normal(rng, (2048, 128), "bf16")
    idx = rng.integers(0, 2048, size=N).astype(np.int32)
    args = [(win, "bf16"), (idx, "i32")]
    want_tpu = win[np.tile(idx[:512], N // 512)]
    got_tpu = _run_jax(tool, "pallas_row_loop", args)
    np.testing.assert_array_equal(got_tpu, want_tpu)
    assert not np.array_equal(got_tpu, win[idx])
    np.testing.assert_array_equal(_run_port(G.gather_rows_window, args),
                                  win[idx])


def test_onehot_plain_runs_in_chunks(monkeypatch):
    """gather_onehot_plain over several row chunks (a ragged last one) ==
    index_select, bit for bit; indices past the window give zero rows."""
    monkeypatch.setattr(G, "ONEHOT_CHUNK", 300)
    rng = np.random.default_rng(14)
    win = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)
                           ).to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 64, size=N).astype(np.int32))
    assert torch.equal(G.gather_onehot_plain(win, idx[:, None]),
                       win.index_select(0, idx.long()))
    out = G.gather_onehot_plain(win, torch.tensor([64, -1], dtype=torch.int32))
    assert not out.any()


TOOLS = {
    "bench_gather2": (bench_gather2, ["--rows", "4096", "--n", "1024"],
                      ["A", "A2", "B", "C", "D"]),
    "bench_gather3": (bench_gather3, ["--n", "1024", "--hw", "4096"],
                      ["S1", "S2", "S3", "G1", "G2", "P1", "P1b", "P2", "P3"]),
    "bench_gather4": (bench_gather4, ["--n", "1024", "--hw", "4096", "--k",
                                      "2"],
                      ["Z", "S1", "S3", "S2", "G1", "G2", "P1", "P2", "P2f",
                       "P3"]),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_end_to_end_on_cpu(name, capsys):
    """Each port tool runs every probe of its JAX counterpart on the CPU at
    a small size (its kernel probes check the kernel call against the plain
    version), prints the device line and one line per probe, and
    without a card refuses to run on its default device."""
    tool, argv, probes = TOOLS[name]
    res = tool.main(["--device", "cpu", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    assert list(res) == probes
    assert lines[0].startswith("device cpu") and len(lines) == 1 + len(probes)
    for r in res.values():
        assert np.isfinite(r["ms"]) and r["ms"] > 0
        if "kernel" in r:
            assert r["launches"] == 0 and r["bound_ms"] > 0
            assert r["max_abs_err"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main([])


TPU_KERNELS = {k: (name, ref) for name, (tool, _, _) in TOOLS.items()
               for k, ref in tool.TPU_KERNELS.items()}


@pytest.mark.parametrize("k", sorted(TPU_KERNELS, key=lambda k: int(k[1:])))
def test_tpu_kernel_references_name_the_pallas_function(k):
    """Each tool's `replaces` reference (file:line) is the `def` of a JAX
    probe function in that tool's counterpart that reaches pl.pallas_call."""
    name, ref = TPU_KERNELS[k]
    path, line = ref.split(":")
    assert path == f"tools/{name}.py"
    lines = (ROOT / path).read_text().splitlines()
    head = lines[int(line) - 1]
    assert head.startswith("def "), head
    body = []
    for text in lines[int(line):]:
        if text and not text[0].isspace():
            break
        body.append(text)
    assert any("pl.pallas_call(" in t for t in body), head


def _tile_blocks_brute(idx, win_rows, tile):
    """(tile, k16 block) pairs hit, counted row by row."""
    hit = set()
    for q, i in enumerate(idx):
        if 0 <= i < win_rows:
            hit.add((q // tile, i // 16))
    return len(hit)


@pytest.mark.parametrize("n,win_rows,tile", [(1, 16, 16), (1000, 48, 16),
                                             (4096, 512, 16), (777, 2048, 16),
                                             (300, 64, 64)])
def test_onehot_tile_blocks_matches_brute_force(n, win_rows, tile):
    """The executed-product count of the one-hot kernel: the (tile, block)
    pairs idx hits, indices outside the window (-1, W, -17) hitting none."""
    rng = np.random.default_rng(n + win_rows)
    idx = rng.integers(-3, win_rows + 3, size=n).astype(np.int32)
    idx[:3] = (-1, win_rows, -17)[:n]
    got = G.onehot_tile_blocks(torch.from_numpy(idx[:, None]), win_rows,
                               tile)
    assert got == _tile_blocks_brute(idx.tolist(), win_rows, tile)


@pytest.mark.parametrize("name", ["bench_gather3", "bench_gather4"])
def test_onehot_cases_bound_by_bytes(name):
    """K9/K13 are gathers: their bound counts bytes alone. Beside it the
    case names the dense product and the one the kernel executes on these
    indices, (tile, block) pairs x 2 * 16 * 16 * 128."""
    tool, k = {"bench_gather3": (bench_gather3, "K9"),
               "bench_gather4": (bench_gather4, "K13")}[name]
    inp = tool.make_inputs(torch.device("cpu"), n=1024, hw=4096)
    case = next(c for c in tool.cases(inp) if c.k == k)
    win = inp["win_bf"][:bench_gather3.OH_WIN] if k == "K9" else inp["win"]
    idx = (inp["idx_oh"] if k == "K9"
           else inp["idx"] % bench_gather4.WIN).reshape(-1)
    b_ms, by = bound_ms(case.flops, case.nbytes)
    assert case.flops == 0 and by == "bytes" and b_ms > 0
    assert case.nbytes == (win.numel() * 2 + idx.numel() * 4
                           + idx.numel() * 128 * 2)
    dense, executed = case.product
    assert dense == 2. * 1024 * win.shape[0] * 128
    blocks = _tile_blocks_brute(idx.tolist(), win.shape[0], 16)
    assert executed == blocks * 2. * 16 * 16 * 128
    assert 0 < executed < dense
