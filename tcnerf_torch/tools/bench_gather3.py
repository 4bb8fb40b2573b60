"""Gather probes on the card, round 2: the primitives a sorted-window fused
gather needs, the port of tools/bench_gather3.py.

  S1  torch.sort            int32 keys, N = 786,432
  S2  torch.sort + gather   key + 16 B payload (4 x f32)
  S3  torch.argsort         int32 keys
  G1  library gather        [N, 4] f32 (is ns/row width-dependent?)
  G2  library gather        [H*W, 128] bf16
  P1  window kernel (G2)    out[q] = win[idx[q]], [2048, 128] f32   for K7
  P1b window kernel (G2)    the same in bf16                        for K7
  P2  lane kernel (G3)      out[q, l] = src[q, idx[q, l]], bf16     for K8
  P3  one-hot kernel (G4)   onehot(idx) @ win, 512-row window       for K9

P1 computes the intended gather out[q] = win[idx[q]]. The TPU kernel reads
the prefetched indices with the tile-local q, so there every 512-query tile
gathers the rows of the first 512 indices (see PERF.md); on a card with
caches that would measure the L1, not the gather.

    python3 -m tcnerf_torch.tools.bench_gather3            # on the card
    python3 -m tcnerf_torch.tools.bench_gather3 --device cpu --n 1024 \
        --hw 4096                                          # plain versions
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gather import (gather_lanes, gather_lanes_plain, gather_onehot,
                          gather_onehot_plain, gather_rows_plain,
                          gather_rows_window)
from .common import (KernelCase, base_parser, check_case, device_line,
                     dtype_name, nbytes, onehot_product, probe, to_torch)

N = 786_432          # queries per render chunk (4096 rays x 192 samples)
HW = 480 * 640
WIN = 2048
OH_WIN = 512
LANES = 128
# the TPU kernel each kernel probe ports (file:line of its function)
TPU_KERNELS = {"K7": "tools/bench_gather3.py:80",
               "K8": "tools/bench_gather3.py:113",
               "K9": "tools/bench_gather3.py:161"}


def make_inputs(device: torch.device, seed: int = 0, n: int = N,
                hw: int = HW) -> Dict:
    """The reference's arrays, drawn in its order from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    f32, bf, i32 = torch.float32, torch.bfloat16, torch.int32
    inp = dict(keys=to_torch(rng.integers(0, hw, size=n), i32, device))
    inp["pay"] = [to_torch(rng.normal(size=n), f32, device) for _ in range(4)]
    inp["tbl4"] = to_torch(rng.normal(size=(n, 4)), f32, device)
    inp["tbl128"] = to_torch(rng.normal(size=(hw, LANES)), bf, device)
    inp["idx_n"] = to_torch(rng.integers(0, n, size=n), i32, device)
    inp["idx_hw"] = to_torch(rng.integers(0, hw, size=n), i32, device)
    inp["win"] = to_torch(rng.normal(size=(WIN, LANES)), f32, device)
    inp["win_bf"] = inp["win"].to(bf)
    inp["idx_win"] = to_torch(rng.integers(0, WIN, size=n), i32, device)
    inp["src"] = to_torch(rng.normal(size=(n, LANES)), bf, device)
    inp["idx_lane"] = to_torch(rng.integers(0, LANES, size=(n, LANES)), i32,
                               device)
    inp["idx_oh"] = to_torch(rng.integers(0, OH_WIN, size=(n, 1)), i32,
                             device)
    return inp


def cases(inp: Dict) -> List[KernelCase]:
    idx_win, src, idx_lane, idx_oh = (inp["idx_win"], inp["src"],
                                      inp["idx_lane"], inp["idx_oh"])
    n = idx_win.shape[0]
    win_oh = inp["win_bf"][:OH_WIN]
    iw64, il64, io64 = idx_win.long(), idx_lane.long(), idx_oh.reshape(-1).long()

    def window(k, probe_name, win):
        return KernelCase(
            k, probe_name, "gather_rows_window",
            f"[{WIN}x{LANES}] {dtype_name(win)} window, N {n}",
            lambda: gather_rows_window(win, idx_win),
            lambda: gather_rows_plain(win, idx_win),
            lambda: win.index_select(0, iw64), 0.,
            nbytes(win, idx_win) + n * LANES * win.element_size())

    return [
        window("K7", "P1", inp["win"]),
        window("K7", "P1b", inp["win_bf"]),
        KernelCase("K8", "P2", "gather_lanes", f"[{n}x{LANES}] bf16 rows",
                   lambda: gather_lanes(src, idx_lane),
                   lambda: gather_lanes_plain(src, idx_lane),
                   lambda: torch.gather(src, 1, il64), 0.,
                   2 * nbytes(src) + nbytes(idx_lane)),
        KernelCase("K9", "P3", "gather_onehot",
                   f"[{OH_WIN}x{LANES}] bf16 window, N {n}",
                   lambda: gather_onehot(win_oh, idx_oh),
                   lambda: gather_onehot_plain(win_oh, idx_oh),
                   lambda: win_oh.index_select(0, io64), 0.,
                   nbytes(win_oh, idx_oh) + n * LANES * 2,
                   product=onehot_product(win_oh, idx_oh)),
    ]


def run(inp: Dict, device: torch.device, iters: int = 5) -> Dict:
    """Every probe, one line each; returns {probe letter: result}."""
    keys, pay = inp["keys"], inp["pay"]
    n = keys.shape[0]
    pay4 = torch.stack(pay, 1)
    idx_n64, idx_hw64 = inp["idx_n"].long(), inp["idx_hw"].long()

    def sort_payload():
        vals, perm = torch.sort(keys)
        return vals, pay4.index_select(0, perm)

    res = {
        "S1": probe("S1 torch.sort i32", lambda: torch.sort(keys).values, n,
                    device, iters),
        "S2": probe("S2 sort + 16 B payload", sort_payload, n, device, iters),
        "S3": probe("S3 torch.argsort", lambda: torch.argsort(keys), n,
                    device, iters),
        "G1": probe("G1 library gather [N,4] f32",
                    lambda: inp["tbl4"].index_select(0, idx_n64), n, device,
                    iters),
        "G2": probe("G2 library gather [HW,128] bf16",
                    lambda: inp["tbl128"].index_select(0, idx_hw64), n,
                    device, iters),
    }
    names = {"P1": "P1 window kernel f32 (K7)",
             "P1b": "P1b window kernel bf16 (K7)",
             "P2": "P2 lane kernel bf16 (K8)",
             "P3": f"P3 one-hot kernel win={OH_WIN} (K9)"}
    for case in cases(inp):
        err = check_case(case)
        res[case.probe] = probe(names[case.probe], case.call, n, device,
                                iters, case.kernel, case.flops, case.nbytes,
                                product=case.product)
        res[case.probe]["max_abs_err"] = err
    return res


def main(argv=None) -> Dict:
    p = base_parser(__doc__)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--hw", type=int, default=HW)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    print(device_line(device), flush=True)
    return run(make_inputs(device, a.seed, a.n, a.hw), device)


if __name__ == "__main__":
    main(sys.argv[1:])
