"""Gather probes on the card, round 3: each op runs K = 16 times back to
back with a data dependence (the next input depends on the last output:
`idx + out[:, 0]`), timed with CUDA events, so the time per op is the
device's marginal cost. The port of tools/bench_gather4.py.

  Z    noop x + i
  S1   torch.sort, S3 torch.argsort, S2 sort + 16 B payload
  G1   library gather [N, 4] bf16,  G2 library gather [H*W, 128] bf16
  P1   window kernel (G2), [2048, 128] bf16 window     for K10
  P2   lane kernel (G3), bf16                          for K11
  P2f  lane kernel (G3), f32                           for K12
  P3   one-hot kernel (G4), 2048-row window            for K13

P1 computes the intended gather out[q] = win[idx[q]] (bench_gather3.py's
docstring says why the TPU kernel's tile-local indices are not copied).

    python3 -m tcnerf_torch.tools.bench_gather4            # on the card
    python3 -m tcnerf_torch.tools.bench_gather4 --device cpu --n 1024 \
        --hw 4096 --k 2                                    # plain versions
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gather import (gather_lanes, gather_lanes_plain, gather_onehot,
                          gather_onehot_plain, gather_rows_plain,
                          gather_rows_window)
from .common import (KernelCase, base_parser, check_case, device_line,
                     dtype_name, nbytes, onehot_product, probe, to_torch)

N = 786_432
HW = 480 * 640
K = 16          # ops per timed call
WIN = 2048
LANES = 128
# the TPU kernel each kernel probe ports (file:line of its function)
TPU_KERNELS = {"K10": "tools/bench_gather4.py:87",
               "K11": "tools/bench_gather4.py:112",
               "K12": "tools/bench_gather4.py:138",
               "K13": "tools/bench_gather4.py:168"}


def make_inputs(device: torch.device, seed: int = 0, n: int = N,
                hw: int = HW) -> Dict:
    """The reference's arrays, drawn in its order from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    f32, bf, i32 = torch.float32, torch.bfloat16, torch.int32
    inp = dict(keys=to_torch(rng.integers(0, hw, size=n), i32, device))
    inp["pay"] = [to_torch(rng.normal(size=n), f32, device) for _ in range(4)]
    inp["tbl4"] = to_torch(rng.normal(size=(n, 4)), bf, device)
    inp["tbl128"] = to_torch(rng.normal(size=(hw, LANES)), bf, device)
    inp["idx"] = to_torch(rng.integers(0, n, size=n), i32, device)
    inp["win"] = to_torch(rng.normal(size=(WIN, LANES)), bf, device)
    inp["src"] = to_torch(rng.normal(size=(n, LANES)), bf, device)
    inp["srcf"] = inp["src"].float()
    inp["idxl"] = to_torch(rng.integers(0, LANES, size=(n, LANES)), i32,
                           device)
    return inp


# ---- the ops: op(carry, i, *args) -> next carry, as in the reference
def op_noop(x, i):
    return x + i


def op_sort(keys, i):
    return torch.sort(keys + i).values


def op_argsort(keys, i):
    return torch.argsort(keys + i).to(torch.int32)


def op_sort_payload(keys, i, pay4):
    vals, perm = torch.sort(keys + i)
    pay4.index_select(0, perm)
    return vals


def op_gather(idx, i, tbl):
    out = tbl.index_select(0, ((idx + i) % tbl.shape[0]).long())
    return idx + out[:, 0].to(torch.int32)


def op_row_window(idx, i, win):
    out = gather_rows_window(win, (idx + i) % WIN)
    return idx + out[:, 0].to(torch.int32)


def op_lanes(idx, i, src):
    out = gather_lanes(src, (idx + i) % LANES)
    return idx + out[:, :1].to(torch.int32)


def op_onehot(idx, i, win):
    out = gather_onehot(win, ((idx + i) % WIN)[:, None])
    return idx + out[:, 0].to(torch.int32)


def amortized(op: Callable, carry: torch.Tensor, *args, k: int = K
              ) -> Callable:
    """A call that runs op k times, each on the last one's output."""
    def run():
        x = carry
        for i in range(k):
            x = op(x, i, *args)
        return x
    return run


def cases(inp: Dict) -> List[KernelCase]:
    """The kernels at the shapes of one op (its first step, i = 0)."""
    idx, win, src, srcf, idxl = (inp["idx"], inp["win"], inp["src"],
                                 inp["srcf"], inp["idxl"])
    n = idx.shape[0]
    idx_w = idx % WIN
    iw64, il64 = idx_w.long(), idxl.long()
    out_w = n * LANES * win.element_size()

    def lanes(k, probe_name, s):
        return KernelCase(
            k, probe_name, "gather_lanes",
            f"[{n}x{LANES}] {dtype_name(s)} rows",
            lambda: gather_lanes(s, idxl), lambda: gather_lanes_plain(s, idxl),
            lambda: torch.gather(s, 1, il64), 0., 2 * nbytes(s) + nbytes(idxl))

    return [
        KernelCase("K10", "P1", "gather_rows_window",
                   f"[{WIN}x{LANES}] bf16 window, N {n}",
                   lambda: gather_rows_window(win, idx_w),
                   lambda: gather_rows_plain(win, idx_w),
                   lambda: win.index_select(0, iw64), 0.,
                   nbytes(win, idx_w) + out_w),
        lanes("K11", "P2", src),
        lanes("K12", "P2f", srcf),
        KernelCase("K13", "P3", "gather_onehot",
                   f"[{WIN}x{LANES}] bf16 window, N {n}",
                   lambda: gather_onehot(win, idx_w),
                   lambda: gather_onehot_plain(win, idx_w),
                   lambda: win.index_select(0, iw64), 0.,
                   nbytes(win, idx_w) + out_w,
                   product=onehot_product(win, idx_w)),
    ]


def run(inp: Dict, device: torch.device, k: int = K, outer: int = 3) -> Dict:
    """Every probe, one line each (ms per op); returns {probe: result}."""
    keys, idx = inp["keys"], inp["idx"]
    n = keys.shape[0]
    pay4 = torch.stack(inp["pay"], 1)

    def go(name, op, carry, *args, case=None):
        fn = amortized(op, carry, *args, k=k)
        if case is None:
            return probe(name, fn, n, device, outer, per_call=k)
        return dict(probe(name, fn, n, device, outer, case.kernel, case.flops,
                          case.nbytes, per_call=k, product=case.product),
                    max_abs_err=errs[case.probe])

    kc = {case.probe: case for case in cases(inp)}
    errs = {p: check_case(case) for p, case in kc.items()}
    return {
        "Z": go("Z   noop x+i", op_noop, keys),
        "S1": go("S1  torch.sort", op_sort, keys),
        "S3": go("S3  torch.argsort", op_argsort, keys),
        "S2": go("S2  sort + 16 B payload", op_sort_payload, keys, pay4),
        "G1": go("G1  gather [N,4] bf16", op_gather, idx, inp["tbl4"]),
        "G2": go("G2  gather [HW,128] bf16", op_gather, idx, inp["tbl128"]),
        "P1": go("P1  window kernel (K10)", op_row_window, idx, inp["win"],
                 case=kc["P1"]),
        "P2": go("P2  lane kernel bf16 (K11)", op_lanes, inp["idxl"],
                 inp["src"], case=kc["P2"]),
        "P2f": go("P2f lane kernel f32 (K12)", op_lanes, inp["idxl"],
                  inp["srcf"], case=kc["P2f"]),
        "P3": go(f"P3  one-hot kernel win={WIN} (K13)", op_onehot, idx,
                 inp["win"], case=kc["P3"]),
    }


def main(argv=None) -> Dict:
    p = base_parser(__doc__)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--hw", type=int, default=HW)
    p.add_argument("--k", type=int, default=K)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    print(device_line(device), flush=True)
    return run(make_inputs(device, a.seed, a.n, a.hw), device, a.k)


if __name__ == "__main__":
    main(sys.argv[1:])
