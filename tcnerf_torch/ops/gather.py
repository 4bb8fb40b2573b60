"""Gather kernels of the TPU gather probes (tools/bench_gather{2,3,4}.py,
K4-K13): wrappers of the CUDA kernels in `csrc/gather.cu` and their plain
PyTorch versions.

  * `gather_rows` (G1, for K4): out[q] = table[idx[q]] from global memory,
    the rows copied in L2-sized bands of the table so that a row's re-reads
    hit L2;
  * `gather_rows_window` (G2, for K5, K6, K7, K10): the same function from a
    window staged in shared memory;
  * `gather_lanes` (G3, for K8, K11, K12): out[q, l] = src[q, idx[q, l]]
    within 128-wide rows, by lane shuffles;
  * `gather_onehot` (G4, for K9, K13): onehot(idx) @ win on the tensor cores,
    f32 accumulation, bf16 out, over only the k16 blocks of the window that
    each 16-row tile indexes (`onehot_tile_blocks` counts them); exact, since
    each output element is one product 1.0 * x plus zeros.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises `ValueError`. Indices outside the table, window or row are outside
the function: nothing checks them per element.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import KernelLib, ptr, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int
GATHER = KernelLib("gather.cu", {
    "gather_rows_launch": [_P, _P, _P, _I, _I, _I, _P],
    "gather_window_launch": [_P, _P, _P, _I, _I, _I, _P],
    "gather_lanes_launch": [_P, _P, _P, _I, _I, _P],
    "gather_onehot_launch": [_P, _P, _P, _I, _I, _P],
})

LANES = 128                # row width of gather_lanes and gather_onehot
MAX_SMEM = 232448          # a block's shared memory on the H100
ONEHOT_CHUNK = 65536       # rows per one-hot product in the plain version
ONEHOT_TILE = 16           # rows per tile of the one-hot kernel (one mma.sync)
# the largest one-hot window: its narrowest slab, 16 columns padded to 24
# bf16 (48 bytes a row), fits in shared memory beside 32 warps' 16-row
# staging tiles (gather.cu `oh_smem`)
ONEHOT_MAX_WIN = (MAX_SMEM - 32 * 16 * 48) // 48 // 16 * 16


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[q] = table[idx[q]] (also the plain version of the window gather)."""
    return table.index_select(0, idx.long())


def gather_lanes_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[q, l] = src[q, idx[q, l]]."""
    return torch.gather(src, 1, idx.long())


def gather_onehot_plain(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """onehot(idx) @ win in f32, cast back to win's dtype. In row chunks: at
    786,432 rows and a 2048-row window the whole one-hot matrix would take
    6.4 GB in f32."""
    idx = idx.reshape(-1)
    cols = torch.arange(win.shape[0], device=win.device)
    wf = win.float()
    out = [((cols == idx[i:i + ONEHOT_CHUNK, None]).to(win.dtype).float() @ wf)
           .to(win.dtype) for i in range(0, idx.shape[0], ONEHOT_CHUNK)]
    return torch.cat(out) if out else win.new_empty((0, win.shape[1]))


def onehot_tile_blocks(idx: torch.Tensor, win_rows: int,
                       tile: int = ONEHOT_TILE) -> int:
    """The (tile, k16 block) pairs that `idx` hits: rows q // tile, blocks
    idx // 16 of a window of `win_rows` rows, indices outside it hitting
    none. The one-hot kernel multiplies exactly these blocks, so its product
    is this count x 2 * tile * 16 * 128 operations."""
    idx = idx.reshape(-1).long()
    q = torch.arange(idx.numel(), device=idx.device)
    hit = (idx >= 0) & (idx < win_rows)
    keys = (q[hit] // tile) * ((win_rows + 15) // 16) + idx[hit] // 16
    return int(torch.unique(keys).numel())


def _check(cond: bool, fn: str, msg: str):
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_cuda(fn: str, data: torch.Tensor, idx: torch.Tensor,
                dtypes, idx_shape):
    _check(data.device.type == "cuda", fn, f"unsupported device {data.device}")
    _check(data.dtype in dtypes, fn, f"dtype {data.dtype} not in {dtypes}")
    _check(data.dim() == 2 and data.is_contiguous()
           and data.data_ptr() % 16 == 0, fn,
           "data must be a contiguous, 16-byte aligned [rows, C] tensor")
    _check(idx.dtype == torch.int32 and idx.is_contiguous()
           and idx.device == data.device and tuple(idx.shape) == idx_shape,
           fn, f"idx must be contiguous int32 {list(idx_shape)} on the data's "
               f"device")
    _check(idx.data_ptr() % 16 == 0, fn, "idx must be 16-byte aligned")


def _row_bytes(fn: str, data: torch.Tensor) -> int:
    row_bytes = data.shape[1] * data.element_size()
    _check(row_bytes % 16 == 0 and data.shape[0] >= 1, fn,
           "rows must be a multiple of 16 bytes, at least one row")
    return row_bytes


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G1: out[q] = table[idx[q]]; table [R, C] bf16 or f32, idx [N] int32.

    Replaces K4 `pallas_dma_gather` (tools/bench_gather2.py:66). Device
    memory bounds it: each touched row read once, each output row written
    once. A table larger than the L2 (315 MB at K4 against 50 MB) misses on
    every random read, so the kernel walks the table in bands of about a
    quarter of the L2: each CTA sorts its slice of the queries by band in
    shared memory and copies the rows band by band, with streaming stores,
    so that the CTAs' reads fall in one band at a time and a row's re-reads
    hit L2. The band count follows from the table's bytes."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    fn = "gather_rows"
    n = idx.shape[0] if idx.dim() == 1 else -1
    _check_cuda(fn, table, idx, (torch.bfloat16, torch.float32), (n,))
    row_bytes = _row_bytes(fn, table)
    out = torch.empty((n, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if n:
        GATHER.call("gather_rows_launch", ptr(table), ptr(idx), ptr(out), n,
                    table.shape[0], row_bytes, stream_handle(table.device))
        GATHER.counts[fn] += 1
    return out


def gather_rows_window(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G2: out[q] = win[idx[q]] from a window staged in shared memory; win
    [W, C] bf16 or f32 with W * 16 bytes <= 227 KB, idx [N] int32."""
    if win.device.type == "cpu":
        return gather_rows_plain(win, idx)
    fn = "gather_rows_window"
    n = idx.shape[0] if idx.dim() == 1 else -1
    _check_cuda(fn, win, idx, (torch.bfloat16, torch.float32), (n,))
    row_bytes = _row_bytes(fn, win)
    _check(win.shape[0] * 16 <= MAX_SMEM, fn,
           f"window of {win.shape[0]} rows: a 16-byte slab of every row must "
           f"fit in {MAX_SMEM} bytes of shared memory")
    out = torch.empty((n, win.shape[1]), dtype=win.dtype, device=win.device)
    if n:
        GATHER.call("gather_window_launch", ptr(win), ptr(idx), ptr(out), n,
                    win.shape[0], row_bytes, stream_handle(win.device))
        GATHER.counts[fn] += 1
    return out


def gather_lanes(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G3: out[q, l] = src[q, idx[q, l]]; src [N, 128] bf16 or f32, idx
    [N, 128] int32 in [0, 128)."""
    if src.device.type == "cpu":
        return gather_lanes_plain(src, idx)
    fn = "gather_lanes"
    n = src.shape[0]
    _check_cuda(fn, src, idx, (torch.bfloat16, torch.float32), (n, LANES))
    _check(src.shape[1] == LANES, fn, f"rows must be {LANES} wide")
    out = torch.empty_like(src)
    if n:
        GATHER.call("gather_lanes_launch", ptr(src), ptr(idx), ptr(out), n,
                    int(src.dtype == torch.float32), stream_handle(src.device))
        GATHER.counts[fn] += 1
    return out


def gather_onehot(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G4: onehot(idx) @ win on the tensor cores; win [W, 128] bf16 with W a
    multiple of 16 up to `ONEHOT_MAX_WIN` (4,320), idx [N] or [N, 1] int32;
    out [N, 128] bf16.

    Replaces K9 and K13 `pallas_onehot` (tools/bench_gather3.py:161,
    tools/bench_gather4.py:168). Device memory bounds it (the output rows):
    the dense product, 2 * N * W * 128 operations, would take about as long
    as the library gather, but a k16 block of the window that none of a
    16-row tile's indices hit adds only zeros. Each warp multiplies only the
    blocks its tile hits (`onehot_tile_blocks`), from a window held resident
    in shared memory in column slabs by persistent CTAs. W is limited by
    the narrowest slab (16 columns of every row) fitting in shared memory
    beside the warps' output staging tiles."""
    if win.device.type == "cpu":
        return gather_onehot_plain(win, idx)
    fn = "gather_onehot"
    n = idx.shape[0]
    _check(idx.dim() == 1 or tuple(idx.shape) == (n, 1), fn,
           "idx must be [N] or [N, 1]")
    _check_cuda(fn, win, idx.reshape(-1), (torch.bfloat16,), (n,))
    _check(win.shape[1] == LANES and win.shape[0] >= 16
           and win.shape[0] % 16 == 0 and win.shape[0] <= ONEHOT_MAX_WIN, fn,
           f"win must be [W, {LANES}] with W a positive multiple of 16, at "
           f"most {ONEHOT_MAX_WIN}")
    out = torch.empty((n, LANES), dtype=win.dtype, device=win.device)
    if n:
        GATHER.call("gather_onehot_launch", ptr(win), ptr(idx), ptr(out), n,
                    win.shape[0], stream_handle(win.device))
        GATHER.counts[fn] += 1
    return out
