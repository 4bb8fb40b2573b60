"""The grasp energy's probe chain: wrapper of the CUDA kernel pair
`csrc/probe.cu`.

Per probe row of `GraspEBM.energy_prepared` on the corner-gather path
with one view (pixel xy, camera-frame position and direction), the chain
gathers the corner image's bilinear tap, adds layer_0's geometry head on
the Fourier encoding, runs the residual blocks, and ends in the grasp
readout's per-probe part: each tapped activation's Dense(64) and
activation, then the combined Dense(64) and activation, [rows, 64]. The
per-pose part of the readout stays in PyTorch (`GraspReadout.pose_energies`);
the plain version of the whole is `GraspEBM.probe_chain_plain`.

The weights come as lists of (weight [out, in], bias) pairs, as
`pack_swg` and `pack_chain` take them (`ProbeWeights`); `pack_probe` packs
them once per weights version into the `ProbePack` the kernels read.
`probe_chain` is differentiable in the three per-row inputs: its backward
is the second kernel, which returns d(pixel xy, position, direction) from
d(out) through the relu masks and the activation's derivative that the
forward kept (`probe_buffers`), and computes no gradient of the weights or
of the corner image. So it serves where neither would take one
(`probe_grad_free`): the pose ascent (`opt/pose_optimizer.py` `frozen`)
and energies under `torch.no_grad`. float32 on the card only, hidden 128,
downscales of 64; anything else raises `ValueError`.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from .cuda_lib import KernelLib, ptr, stream_handle

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PROBE = KernelLib("probe.cu", {
    "probe_fwd_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _I,
                         _I, _F, _I, _P, _P, _P, _P],
    "probe_bwd_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                         _F, _I, _P, _P, _P, _P, _P],
})

HIDDEN = 128          # the chain's width
DOWNSCALE = 64        # the readout's downscale and combined widths
TILE = 64             # rows per kernel step
THREADS = 128         # threads of a kernel block
CHUNK = 2048          # floats per chunk of the weight streams
MAX_TAPS = 4
IN = 8                # d(inputs) per row: pixel xy, position, direction


def probe_taps(n_blocks: int) -> Tuple[int, int]:
    """(first tapped block, number of taps): the readout reads the output
    of the last feature block (the view mean's input) and of the fusion
    blocks after it, at most four."""
    nf = n_blocks // 2
    return nf - 1, min(n_blocks - nf + 1, MAX_TAPS)


def tap_slice(n_blocks: int) -> slice:
    """The readout's inputs in the embedding's complete output [layer_0,
    feature blocks, view mean, fusion blocks]: the view mean and the fusion
    blocks' outputs, `probe_taps` of them."""
    first, n_taps = probe_taps(n_blocks)
    return slice(first + 2, first + 2 + n_taps)


Layer = Tuple[torch.Tensor, torch.Tensor]


class ProbeWeights(NamedTuple):
    """The layers the kernels read, each (weight [out, in], bias): layer_0
    (`head`, its first 12 * n_freq columns take the position's and the
    direction's encodings), the residual blocks' two layers each in order
    (`chain`), the downscale of each tapped output (`downscales`) and the
    combined Dense (`combined`); the encoding's octaves and the readout's
    activation (elu, else relu)."""
    head: Layer
    chain: Sequence[Layer]
    downscales: Sequence[Layer]
    combined: Layer
    n_freq: int
    base_freq: float
    elu: bool

    def params(self) -> List[torch.Tensor]:
        layers = [self.head, *self.chain, *self.downscales, self.combined]
        return [t for layer in layers for t in layer]


def probe_fits(w: ProbeWeights) -> bool:
    """Whether the kernels compute these layers: f32, hidden 128, >= 2
    blocks, the encodings within the head's 128 rows, the readout's taps
    and downscales of 64."""
    n_blocks, pd = len(w.chain) // 2, 12 * w.n_freq
    if (len(w.chain) % 2 or n_blocks < 2 or pd > HIDDEN
            or len(w.downscales) != probe_taps(n_blocks)[1]
            or w.head[0].dim() != 2 or w.head[0].shape[1] < pd):
        return False
    shapes = [(w.head, (HIDDEN, w.head[0].shape[1]))]
    shapes += [(layer, (HIDDEN, HIDDEN)) for layer in w.chain]
    shapes += [(layer, (DOWNSCALE, HIDDEN)) for layer in w.downscales]
    shapes += [(w.combined, (DOWNSCALE, DOWNSCALE * len(w.downscales)))]
    return all(tuple(k.shape) == want and tuple(b.shape) == want[:1]
               and k.dtype == b.dtype == torch.float32
               for (k, b), want in shapes)


class ProbePack(NamedTuple):
    """The kernels' view of the weights, built once per weights version:
    `fwd` and `bwd`, each matrix of the chain in the order the kernel uses
    it, [k][n] row-major, in chunks of CHUNK floats (the forward's head is
    layer_0's geometry slice transposed, its rows past 12 * n_freq zero;
    the backward takes each matrix as it is stored, its transpose's
    transpose); `bias` the forward's biases in the order of use; `params`
    the tensors they were packed from (`probe_grad_free`)."""
    fwd: torch.Tensor
    bwd: torch.Tensor
    bias: torch.Tensor
    n_blocks: int
    n_taps: int
    n_freq: int
    base_freq: float
    elu: bool
    params: Tuple[torch.Tensor, ...]


@torch.no_grad()
def pack_probe(w: ProbeWeights) -> ProbePack:
    if not probe_fits(w):
        raise ValueError("pack_probe: the kernels do not compute these "
                         "layers (`probe_fits`)")
    n_blocks = len(w.chain) // 2
    tap0, n_taps = probe_taps(n_blocks)
    ds, (comb, comb_b), pd = w.downscales, w.combined, 12 * w.n_freq
    w0 = w.head[0]

    def share(j):                      # tap j's columns of the combined
        return comb[:, DOWNSCALE * j:DOWNSCALE * (j + 1)]

    head = w0.new_zeros((HIDDEN, HIDDEN))
    head[:pd] = w0[:, :pd].t()
    fwd = [head]
    for b in range(n_blocks):
        fwd += [w.chain[2 * b][0].t(), w.chain[2 * b + 1][0].t()]
        if 0 <= b - tap0 < n_taps:
            fwd += [ds[b - tap0][0].t(), share(b - tap0).t()]
    bwd = []
    for b in reversed(range(n_blocks)):
        if 0 <= b - tap0 < n_taps:
            bwd += [share(b - tap0), ds[b - tap0][0]]
        bwd += [w.chain[2 * b + 1][0], w.chain[2 * b][0]]
    head_t = w0.new_zeros((HIDDEN, HIDDEN))
    head_t[:, :pd] = w0[:, :pd]
    bwd.append(head_t)
    bias = [w.head[1]] + [b for _, b in w.chain] + [b for _, b in ds]
    bias.append(comb_b)

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts]).contiguous()

    return ProbePack(flat(fwd), flat(bwd), flat(bias), n_blocks, n_taps,
                     w.n_freq, float(w.base_freq), bool(w.elu),
                     tuple(w.params()))


def probe_grad_free(pack: ProbePack, corner: torch.Tensor) -> bool:
    """Whether autograd would ask nothing of the kernels but d(rows): grad
    mode off, or neither the weights `pack` was packed from nor the corner
    image require grad."""
    return not torch.is_grad_enabled() or not (
        corner.requires_grad or any(p.requires_grad for p in pack.params))


def probe_buffers(n_rows: int, pack: ProbePack, device) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """What the forward keeps for the backward: each relu's mask as bits,
    a word for each kernel thread's 8 x 8 block of a tile, [tiles, 2 *
    n_blocks, 128] int64, and the readout activation's derivative,
    [tiles * 64, 64 * (n_taps + 1)] f32."""
    tiles = -(-n_rows // TILE)
    masks = torch.empty((tiles, 2 * pack.n_blocks, THREADS),
                        dtype=torch.int64, device=device)
    actd = torch.empty((tiles * TILE, DOWNSCALE * (pack.n_taps + 1)),
                       device=device)
    return masks, actd


def _geometry(corner, rows, rows_per_image):
    return (rows, rows_per_image, corner.shape[1], corner.shape[2])


class _ProbeChain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, coords, pos, dirs, corner, rows_per_image, pack, keep):
        dev, rows = coords.device, coords.shape[0]
        masks, actd = (probe_buffers(rows, pack, dev) if keep
                       else (None, None))
        out = torch.empty((rows, DOWNSCALE), device=dev)
        PROBE.call("probe_fwd_launch", ptr(coords), ptr(pos), ptr(dirs),
                   ptr(corner), *_geometry(corner, rows, rows_per_image),
                   ptr(pack.fwd), pack.fwd.numel() // CHUNK, ptr(pack.bias),
                   pack.n_blocks, pack.n_taps, pack.n_freq, pack.base_freq,
                   int(pack.elu), ptr(masks), ptr(actd), ptr(out),
                   stream_handle(dev))
        PROBE.counts["probe_fwd"] += 1
        if keep:
            ctx.save_for_backward(coords, pos, dirs, corner, masks, actd)
            ctx.rows_per_image, ctx.pack = rows_per_image, pack
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        coords, pos, dirs, corner, masks, actd = ctx.saved_tensors
        pack, dev, rows = ctx.pack, coords.device, coords.shape[0]
        gout = gout.float().contiguous()
        gin = torch.empty((rows, IN), device=dev)
        PROBE.call("probe_bwd_launch", ptr(coords), ptr(pos), ptr(dirs),
                   ptr(corner), *_geometry(corner, rows, ctx.rows_per_image),
                   ptr(pack.bwd), pack.bwd.numel() // CHUNK, pack.n_blocks,
                   pack.n_taps, pack.n_freq, pack.base_freq, int(pack.elu),
                   ptr(masks), ptr(actd), ptr(gout), ptr(gin),
                   stream_handle(dev))
        PROBE.counts["probe_bwd"] += 1
        return gin[:, :2], gin[:, 2:5], gin[:, 5:], None, None, None, None


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"probe_chain: {msg}")


def probe_chain(coords: torch.Tensor, pos: torch.Tensor, dirs: torch.Tensor,
                corner: torch.Tensor, rows_per_image: int,
                pack: ProbePack) -> torch.Tensor:
    """The probe chain of rows ordered (image, pose, probe): coords [R, 2]
    pixel (x, y), pos and dirs [R, 3], corner [I, H, W, 4 * 128] (`GraspEBM.
    prepare`) with I * rows_per_image == R, all f32, contiguous, on one
    card, through the kernels from `pack` -> [R, 64]; differentiable in
    coords, pos, dirs (`probe_grad_free` must hold)."""
    rows = coords.shape[0]
    dev = coords.device
    for name, t, width in (("coords", coords, 2), ("pos", pos, 3),
                           ("dirs", dirs, 3)):
        _check(t.dim() == 2 and t.shape == (rows, width)
               and t.dtype == torch.float32 and t.is_contiguous()
               and t.device == dev,
               f"{name} must be contiguous f32 [{rows}, {width}] on one "
               "device")
    _check(corner.dim() == 4 and corner.shape[3] == 4 * HIDDEN
           and corner.dtype == torch.float32 and corner.is_contiguous()
           and corner.device == dev and min(corner.shape[1:3]) >= 2,
           "corner must be contiguous f32 [I, H >= 2, W >= 2, 512] on "
           "coords' device")
    _check(rows_per_image > 0
           and corner.shape[0] * rows_per_image == rows,
           f"{corner.shape[0]} images of {rows_per_image} rows are not "
           f"{rows} rows")
    _check(pack.fwd.device == dev and pack.bwd.device == dev
           and pack.fwd.numel() == pack.bwd.numel()
           and pack.fwd.numel() % CHUNK == 0,
           "pack must hold both streams on coords' device")
    _check(probe_grad_free(pack, corner),
           "the weights or the corner image would take a gradient, which "
           "the kernels do not compute")
    _check(dev.type == "cuda", f"the kernels run on the card, not {dev}; "
           "`GraspEBM.probe_chain_plain` is the plain version")
    keep = torch.is_grad_enabled() and (coords.requires_grad
                                        or pos.requires_grad
                                        or dirs.requires_grad)
    return _ProbeChain.apply(coords, pos, dirs, corner, rows_per_image, pack,
                             keep)
