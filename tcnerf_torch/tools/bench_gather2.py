"""Gather probes on the card: scattered row gathers of a [H*W, 512] bf16
corner image (1 KB rows), the port of tools/bench_gather2.py.

  A   library row gather (index_select)       the baseline
  A2  A with sorted indices                   does the card exploit locality?
  B   row-gather kernel, global memory (G1)   for K4 pallas_dma_gather
  C   window kernel, shared memory (G2)       for K5 pallas_vmem_loop
  D   window kernel, shared memory (G2)       for K6 pallas_vmem_take

C and D gather from a [2048, 512] patch with indices in [0, 2048). On the
TPU they were two ways to read a VMEM patch (a scalar loop and jnp.take);
on the card both are the one shared-memory window kernel.

    python3 -m tcnerf_torch.tools.bench_gather2            # on the card
    python3 -m tcnerf_torch.tools.bench_gather2 --device cpu --rows 4096 \
        --n 1024                                           # plain versions
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gather import gather_rows, gather_rows_plain, gather_rows_window
from .common import (KernelCase, base_parser, check_case, device_line,
                     nbytes, probe, to_torch)

ROWS, C = 480 * 640, 512          # corner-image rows: 4 x 128 bf16 = 1 KB
N = 512 * 1024                    # queries (fine stage of one 4096-ray chunk)
PATCH = 2048
# the TPU kernel each kernel probe ports (file:line of its function)
TPU_KERNELS = {"K4": "tools/bench_gather2.py:66",
               "K5": "tools/bench_gather2.py:99",
               "K6": "tools/bench_gather2.py:122"}


def make_inputs(device: torch.device, seed: int = 0, rows: int = ROWS,
                n: int = N) -> Dict:
    """The reference's arrays, drawn in its order from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    img = to_torch(rng.normal(size=(rows, C)), bf, device)
    idx = to_torch(rng.integers(0, rows, size=n), torch.int32, device)
    idx_small = to_torch(rng.integers(0, PATCH, size=n), torch.int32, device)
    return dict(img=img, idx=idx, idx_sorted=torch.sort(idx).values,
                idx_small=idx_small, patch=img[:PATCH].contiguous())


def cases(inp: Dict) -> List[KernelCase]:
    img, idx, patch, small = (inp["img"], inp["idx"], inp["patch"],
                              inp["idx_small"])
    idx64, small64 = idx.long(), small.long()
    row_bytes = img.shape[1] * img.element_size()
    out_bytes = idx.shape[0] * row_bytes
    # the table rows this run's indices touch, each read once
    touched = torch.unique(idx).numel() * row_bytes
    win = dict(kernel="gather_rows_window",
               mode=f"[{patch.shape[0]}x{patch.shape[1]}] bf16 window, "
                    f"N {idx.shape[0]}",
               call=lambda: gather_rows_window(patch, small),
               plain=lambda: gather_rows_plain(patch, small),
               library=lambda: patch.index_select(0, small64), flops=0.,
               nbytes=nbytes(patch, small) + out_bytes)
    return [
        KernelCase("K4", "B", "gather_rows",
                   f"[{img.shape[0]}x{img.shape[1]}] bf16 table, N "
                   f"{idx.shape[0]}",
                   lambda: gather_rows(img, idx),
                   lambda: gather_rows_plain(img, idx),
                   lambda: img.index_select(0, idx64), 0.,
                   touched + nbytes(idx) + out_bytes),
        KernelCase("K5", "C", **win),
        KernelCase("K6", "D", **win),
    ]


def run(inp: Dict, device: torch.device, iters: int = 5) -> Dict:
    """Every probe, one line each; returns {probe letter: result}."""
    img, n = inp["img"], inp["idx"].shape[0]
    idx64, sorted64 = inp["idx"].long(), inp["idx_sorted"].long()
    res = {"A": probe("A  library index_select",
                      lambda: img.index_select(0, idx64), n, device, iters),
           "A2": probe("A2 library, sorted idx",
                       lambda: img.index_select(0, sorted64), n, device,
                       iters)}
    names = {"B": "B  row-gather kernel (K4)", "C": "C  window kernel (K5)",
             "D": "D  window kernel (K6)"}
    for case in cases(inp):
        err = check_case(case)
        res[case.probe] = probe(names[case.probe], case.call, n, device,
                                iters, case.kernel, case.flops, case.nbytes)
        res[case.probe]["max_abs_err"] = err
    return res


def main(argv=None) -> Dict:
    p = base_parser(__doc__)
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--n", type=int, default=N)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    print(device_line(device), flush=True)
    return run(make_inputs(device, a.seed, a.rows, a.n), device)


if __name__ == "__main__":
    main(sys.argv[1:])
