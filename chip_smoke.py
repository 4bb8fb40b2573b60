#!/usr/bin/env python3
"""Chip smoke run of the tcnerf_torch port on one NVIDIA GPU.

    python3 chip_smoke.py             # the whole run (one card)
    python3 chip_smoke.py --kernels   # build + kernel-vs-plain checks only

It builds the port's CUDA kernels from `tcnerf_torch/csrc`, holds every
kernel mode against its plain PyTorch version at main-path shapes, runs the
three gather-probe tools (`tcnerf_torch/tools/bench_gather{2,3,4}.py`) at
the reference's shapes and holds their kernels (K4-K13) against their plain
versions bit for bit, serves a
full 480x640 view of the full-width `nerf_1_view_wo` model (seeded random
weights) through `render_view` on the fused swg path, the flax
(`pallas_mlp`) path and the f32 swg path, checks that each path launched its
kernel and that the output is finite, and prints the times. Then it serves
the CLIP-fused models at full width: `nerf_1_view` (fusion v0) on the swg
path (K2) with a profiled view split by the port's profiler ranges, a
v4-elu model gated by the CLIP text tower's embedding of a prompt, and
the bf16 `nerf_3_view` model on the flax path (K1). Then it trains
`nerf_1_view_wo` (f32, K1' in the chain halves) for 4 steps through
`tcnerf_torch.train.train_nerf` on a synthetic dataset, holds K1' against
its plain version and a step with K1' against one with the plain chain,
and prints step time, memory and a profiled step; then the CLIP-fused
trainers (`nerf_1_view`, `nerf_1_view_v4_elu`, `nerf_3_view`: finite
losses, the frozen CLIP tower untouched, the validation strips decoded, K1'
launches per step, K2 / K1 launches per validation render, a profiled
step each). Last it serves grasp poses: `GraspPipeline.infer` on
`goal_1_view` and on `language_1_view` (4096 guesses, 3 images, 16 ascent
steps at full width), checked against a fresh energy of the returned poses
and against the same model on the CPU, with its times, throughput, memory
and a profiled ascent step. Then it trains the grasp energy with the four
grasp entry points (`goal_1_view`, `dngf_1_view`, `trajectory_1_view-2`,
`language_1_view`) at full width for 2 steps each on synthetic datasets,
with their validations by pose ascent, the frozen parameters checked
unchanged, no chain-kernel launch, a profiled step, and one step of each
kind held against the CPU. Last it joins the stages through checkpoint
files (`phase_checkpoint`): a stage-1 run stored and resumed, a view
served from its file, `train_goal` on that backbone and resumed,
`GraspPipeline.from_checkpoints`, `train_language` on the v4-elu
checkpoint and the TF bundle layout, each bit for bit, with every file's
store and load times. Last the hash-grid field (`phase_hashgrid`, at the
JAX configs' width): `nerf_convergence_hashgrid` trained 8 steps through
`train_nerf` (held-out view never drawn, `model_final` resumed bit for
bit, a step card vs CPU), its held-out view served on the plain path at
chunks 512 and 8192 (a chunk card vs CPU), `dngf_hashgrid` trained 2
steps through `train_delta_ngf` with its tables, and served through
`GraspPipeline.from_checkpoints` of that run's files; no chain kernel
launches there. Last the task layer (`phase_collect`): a grasp dataset
collected through `tcnerf_torch.data.collect.collect_grasp_dataset` (the
plugin factory's grasp task, the virtual scene's cameras, the suction
oracle) at 480x640 with its file invariants held, `goal_1_view` and
`dngf_1_view` trained 2 steps each on it, and a validation with the
plugin oracle held equal to `OracleAgent`'s; no chain kernel launches
there either. Then trained quality (`phase_convergence`):
`nerf_convergence_hashgrid_cpu` fit to epoch 256 through
`tcnerf_torch/tools/convergence.py`, its validation PSNR printed beside
the JAX package's record and held at CONVERGENCE_BARS, the full-width
`nerf_convergence` for one step with its two validation renders (K2), and
a `TCNERF_TRACE` run whose Chrome trace must hold CUDA kernels; then the
grasp stage's (`phase_grasp_convergence`): a cut `nerf_convergence_cpu`
backbone, a cut `goal_convergence_cpu` fit on it, its round pickles read
back, `best` reloaded bit for bit, the strong-ascent validation trained
and untrained beside the JAX record and the tool's controlled ratio
(printed; held: trained below untrained), no chain kernel launched;
then both demos (`phase_demos`). Last the parallel package at world size 1 on one
NCCL rank (`phase_parallel`): the dry run's rank checks at tiny widths,
then at full width the sharded 480x640 render (bf16, K1) against
`render_all_rays` bit for bit with as many K1 launches (counted as
`launches_parallel`) and both timed, the sharded pose ascent of
`goal_1_view` (4096 guesses) bit for bit, the sharded and explicit train
steps of `nerf_1_view_wo` (K1'), two updates each, against
`nerf_train_step` (in torch's default mode within stated bars, in its
deterministic mode bit for bit), and `host_shard_indices`. All checkpoints and collected data go under one temporary
directory outside the repository, removed at the end. The last line is
`{"ok": true, "device": {...}}`; any failure exits non-zero before it.
Imports torch and the port only.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

H, W = 480, 640
HID = 128
CHUNK = 8192
N_SAMPLES = 64


def compare(name, got, want, tol, note):
    """max |got - want| <= tol * max |want| (all f32)."""
    import torch
    got, want = got.detach().float(), want.detach().float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = err <= tol * scale
    print(f"check {name}: max_abs_err={err:.6g} limit={tol * scale:.6g} "
          f"({tol} x max|ref| {scale:.6g}; {note}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def phase_build():
    from tcnerf_torch.ops.cuda_lib import build_all
    from tcnerf_torch.ops.gather import GATHER
    from tcnerf_torch.ops.probe import PROBE
    from tcnerf_torch.ops.resmlp import RESMLP
    from tcnerf_torch.ops.swg import SWG

    t0 = time.perf_counter()
    reports = build_all([RESMLP, SWG, GATHER, PROBE])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({len(reports)} nvcc processes in parallel)")
    for source, text in reports.items():
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "error", "warning")):
                print(f"  {source}: {line.strip()}")


def phase_kernels(dev, card):
    """Each kernel mode against its plain version at main-path shapes, then
    timed; the kernels read weights packed once, as the serving paths do.
    K1 and K2 are also timed at the coarse stage's 524,288 rows, so that
    launches x time adds up to a view's device time."""
    import torch
    from tcnerf_torch.ops.resmlp import pack_chain, resmlp_plain, resmlp_rows
    from tcnerf_torch.ops.swg import (encode_head, pack_swg, swg_field_plain,
                                      swg_field_rows)
    from tcnerf_torch.tools.common import bound_ms, random_chain, time_ms

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # K1, the _pallas_chain half: 8192 rays x 128 samples, 3 blocks, bf16
    n = CHUNK * 2 * N_SAMPLES
    x = torch.randn((n, HID), generator=gen, device=dev).to(torch.bfloat16)
    wts = random_chain(gen, 3, None, 0, dev)
    pk = pack_chain(wts, 3, skip_input=True)

    def k1(rows):
        return resmlp_rows(x[:rows], wts, 3, skip_input=True, pack=pk)

    got = k1(n)
    want = resmlp_plain(x, wts, 3, skip_input=True)
    err = compare("K1 resmlp_rows chain half [1048576x128] bf16", got, want,
                  2e-2, "bf16 output rounding, f32 stream")
    results["K1"] = dict(
        err=err, ms=time_ms(lambda: k1(n), dev, 10),
        coarse_ms=time_ms(lambda: k1(n // 2), dev, 10),
        plain_ms=time_ms(lambda: resmlp_plain(x, wts, 3, skip_input=True),
                         dev, 3),
        bound=bound_ms(2 * n * 6 * HID * HID, 2 * n * HID * 2))
    del x, got, want

    # K1, the fused_field form: 379 -> 128 -> 6 blocks -> 4, coarse stage
    n = CHUNK * N_SAMPLES
    x = torch.randn((n, 379), generator=gen, device=dev).to(torch.bfloat16)
    wts = random_chain(gen, 6, 379, 4, dev)
    pk = pack_chain(wts, 6, readout=True)
    got = resmlp_rows(x, wts, 6, readout=True, pack=pk)
    want = resmlp_plain(x, wts, 6, readout=True)
    err = compare("K1 resmlp_rows fused_field form [524288x379 -> 4] bf16",
                  got, want, 2e-2, "bf16 output rounding, f32 stream")
    ms = time_ms(lambda: resmlp_rows(x, wts, 6, readout=True, pack=pk), dev,
                 10)
    pms = time_ms(lambda: resmlp_plain(x, wts, 6, readout=True), dev, 3)
    b, by = bound_ms(2 * n * (379 * HID + 12 * HID * HID + HID * 4),
                     n * (379 + 4) * 2)
    print(f"time K1 fused_field form: {ms:.4f} ms (plain {pms:.4f} ms, "
          f"bound {b:.4f} ms by {by}) [{card}]")
    del x, got, want

    # K2 / K3, fine stage: 8192 rays x 128 samples on a 480x640x128 image
    n = CHUNK * 2 * N_SAMPLES
    img = (torch.randn((H, W, HID), generator=gen, device=dev)
           ).to(torch.bfloat16)
    coords = torch.stack([torch.rand(n, generator=gen, device=dev) * (W - 1),
                          torch.rand(n, generator=gen, device=dev) * (H - 1)],
                         -1).contiguous()
    pos = (torch.randn((n, 3), generator=gen, device=dev) * 0.5).contiguous()
    dirs = (torch.randn((n, 3), generator=gen, device=dev) * 0.5).contiguous()
    head_k = torch.randn((120, HID), generator=gen, device=dev) * 0.09
    head_b = torch.randn((HID,), generator=gen, device=dev) * 0.1
    wts = random_chain(gen, 6, None, 4, dev)
    pk = pack_swg(wts, 6, head_k, head_b)
    args = (img, coords, pos, dirs, wts, 6, head_k, head_b)

    def k2(rows):
        return swg_field_rows(img, coords[:rows], pos[:rows], dirs[:rows],
                              wts, 6, head_k, head_b, pack=pk)

    got = k2(n)
    want = swg_field_plain(*args)
    err = compare("K2 swg head-inside fine stage [1048576 queries]", got,
                  want, 2e-2, "bf16 stream: summation order and bf16 "
                  "roundings differ per layer")
    flops = 2 * n * (120 * HID + 12 * HID * HID + HID * 4)
    nbytes = n * (2 * 4 + 6 * 4 + 4 * 4) + H * W * HID * 2
    results["K2"] = dict(
        err=err, ms=time_ms(lambda: k2(n), dev, 10),
        coarse_ms=time_ms(lambda: k2(n // 2), dev, 10),
        plain_ms=time_ms(lambda: swg_field_plain(*args), dev, 3),
        bound=bound_ms(flops, nbytes))
    del got, want

    h0 = encode_head(pos, dirs, head_k, head_b, torch.bfloat16)
    kw = dict(h0_geo=h0, fast=False)
    got = swg_field_rows(img, coords, None, None, wts, 6, pack=pk, **kw)
    want = swg_field_plain(img, coords, None, None, wts, 6, **kw)
    err = compare("K3 swg head-given fine stage, f32 stream", got, want,
                  2e-2, "bf16 operands: a last-bit difference in the f32 "
                  "stream can flip an operand's bf16 rounding")
    flops = 2 * n * (12 * HID * HID + HID * 4)
    nbytes = n * (2 * 4 + HID * 2 + 4 * 4) + H * W * HID * 2
    results["K3"] = dict(
        err=err,
        ms=time_ms(lambda: swg_field_rows(img, coords, None, None, wts, 6,
                                          pack=pk, **kw), dev, 10),
        plain_ms=time_ms(lambda: swg_field_plain(img, coords, None, None,
                                                 wts, 6, **kw), dev, 3),
        bound=bound_ms(flops, nbytes))
    del img, coords, pos, dirs, got, want, h0
    results.update(probe_kernels(dev, card))
    for k, r in results.items():
        coarse = (f", coarse stage {r['coarse_ms']:.4f} ms"
                  if "coarse_ms" in r else "")
        print(f"time {k}: {r['ms']:.4f} ms{coarse} (plain {r['plain_ms']:.4f}"
              f" ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}) "
              f"[{card}]")
    return results


def probe_setup(dev, guesses=4096, seed=0):
    """goal_1_view's GraspEBM at its widths (seeded weights, and the biases
    the probe kernels read drawn: the initializers leave them zero), its
    validation optimizer with `guesses` initial guesses, 3 seeded 480x640
    images and features on a camera ring, prepared, and the initial state:
    (model, optimizer, scene, state)."""
    import torch
    from tcnerf_torch.opt.pose_optimizer import PoseOptimizer
    from tcnerf_torch.train.config import load_config
    from tcnerf_torch.train.grasp_common import build_grasp_model

    cfg = load_config([], "goal_1_view")
    model = build_grasp_model(cfg, device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for t in model.probe_weights().params():
            if t.dim() == 1:
                t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.1)
    oc = cfg.validation.grasp_opt_config
    sc = oc.optimization_config
    opt = PoseOptimizer(
        model=model, workspace_bounds=cfg.generator_grasp.workspace_bounds,
        n_initial_guesses=guesses, n_images=oc.optimizer_config.n_images,
        clip_translation=oc.optimizer_config.clip_translation,
        init_lr_t=sc.init_lr_t, decay_t=sc.decay_t, init_lr_r=sc.init_lr_r,
        decay_r=sc.decay_r)
    feats = torch.randn((1, opt.n_images, H, W, model.n_features),
                        generator=gen, device=dev)
    scene = opt.prepare(grasp_scene(opt.n_images, seed), feats)
    return model, opt, scene, opt.init_state(
        opt.generate_initial_guesses(seed))


def probe_kernels(dev, card):
    """P1 / P2, the probe chain's forward and backward kernels, at
    goal_1_view's shape: the rows of 4096 guesses x 3 images x 42 probes
    (516,096) of a synchronised step's poses, against
    `GraspEBM.probe_chain_plain` and autograd through it on the same card,
    forward and d(xy, pos, dir) of a seeded d(out) within 1e-5 of the
    largest |plain|. Timed with CUDA events: the forward keeping nothing
    (the final energies) and keeping the masks (a step), the backward, the
    plain forward, and autograd's backward through it (plain forward and
    backward less the plain forward). The plain path is the library route
    (cuBLAS GEMMs and PyTorch's element-wise kernels). Bound: the f32
    multiply-adds at the FFMA peak (the configuration runs no TF32) or the
    bytes (2 KB of corner rows a row), whichever is larger."""
    import torch
    from tcnerf_torch.core import se3
    from tcnerf_torch.ops.probe import DOWNSCALE, HIDDEN, probe_chain, \
        probe_taps
    from tcnerf_torch.opt.pose_optimizer import frozen
    from tcnerf_torch.tools.common import PEAK_F32_FLOPS, bound_ms, time_ms

    model, opt, scene, state = probe_setup(dev)
    b = opt.batch_size
    poses = se3.pose_to_matrix(state.translations.expand(b, -1, -1),
                               state.rotations.expand(b, -1, -1))
    _, pixel_xy, cam, dirs = model.probe_inputs(poses, scene.intrinsics,
                                                scene.extrinsics_inv)
    rows = [x.reshape(-1, x.shape[-1]).contiguous().detach()
            for x in (pixel_xy, cam, dirs)]
    n, rpi = rows[0].shape[0], opt.n_initial_guesses * model.n_probes
    corner, pack = scene.prepared.corner, model._probe_pack()
    gout = torch.randn((n, DOWNSCALE), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    pd = model.fine_embedding.layer_0.split
    row_flops = 2.0 * (pd * HIDDEN + 2 * model.n_blocks * HIDDEN * HIDDEN
                       + probe_taps(model.n_blocks)[1]
                       * (HIDDEN * DOWNSCALE + DOWNSCALE * DOWNSCALE))
    bound = bound_ms(row_flops * n, n * (4 * HIDDEN * 4 + 8 * 4
                                         + DOWNSCALE * 4), PEAK_F32_FLOPS)
    print(f"probe chain: {n} rows ({opt.n_initial_guesses} guesses x "
          f"{opt.n_images} images x {model.n_probes} probes), "
          f"{row_flops:.0f} FLOP a row each way; bound {bound[0]:.4f} ms by "
          f"{bound[1]} (f32 FFMA at {PEAK_F32_FLOPS / 1e12:.0f} TF/s)")
    res = {}
    with frozen(model):
        ins = [x.clone().requires_grad_() for x in rows]
        out = probe_chain(*ins, corner, rpi, pack)
        g_k = torch.autograd.grad(out, ins, gout, retain_graph=True)
        want = model.probe_chain_plain(*ins, corner, rpi)
        g_p = torch.autograd.grad(want, ins, gout)
        err = compare(f"P1 probe_fwd [{n} rows] f32", out, want, 1e-5,
                      "f32 FFMA, products in k order as cuBLAS's SIMT GEMMs")
        errs = [compare(f"P2 probe_bwd d({name}) [{n} rows] f32", g, w, 1e-5,
                        "f32, another summation order than autograd's")
                for name, g, w in zip(("xy", "pos", "dir"), g_k, g_p)]
        del want, g_p
        with torch.no_grad():
            fwd_ms = time_ms(lambda: probe_chain(*rows, corner, rpi, pack),
                             dev, 10)
            plain_ms = time_ms(lambda: model.probe_chain_plain(
                *rows, corner, rpi), dev, 5)
        keep_ms = time_ms(lambda: probe_chain(*ins, corner, rpi, pack), dev,
                          10)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, ins, gout, retain_graph=True), dev, 10)
        del out

        def plain_both():
            o = model.probe_chain_plain(*ins, corner, rpi)
            return torch.autograd.grad(o, ins, gout)
        both_ms = time_ms(plain_both, dev, 5)
    res["P1"] = dict(err=err, ms=fwd_ms, keep_ms=keep_ms, plain_ms=plain_ms,
                     library_ms=plain_ms, bound=bound)
    res["P2"] = dict(err=max(errs), ms=bwd_ms, plain_ms=both_ms - plain_ms,
                     library_ms=both_ms - plain_ms, bound=bound)
    print(f"time P1 probe_fwd: {fwd_ms:.4f} ms, keeping the masks "
          f"{keep_ms:.4f} ms; P2 probe_bwd: {bwd_ms:.4f} ms; plain forward "
          f"{plain_ms:.4f} ms, plain forward and backward {both_ms:.4f} ms; "
          f"{row_flops * n / fwd_ms / 1e9:.1f} / "
          f"{row_flops * n / bwd_ms / 1e9:.1f} TF/s, "
          f"{100 * bound[0] / fwd_ms:.1f}% / {100 * bound[0] / bwd_ms:.1f}% "
          f"of the bound [{card}]")
    del model, opt, scene, state, rows, ins, corner, pack
    torch.cuda.empty_cache()
    return res


def phase_gather(dev, card, launches):
    """The three gather-probe tools at the reference's shapes (their main
    path: counts set to 0 before each tool, read after). Each tool holds
    every probe's kernel against its plain version, bit for bit (tolerance
    0: a gather moves bits, and the one-hot product is exact); each kernel
    is then timed beside its plain version and the one PyTorch call that
    computes the same function: kernel and library as a CUDA graph of
    launches (`graph_ms`; a ~0.1 ms kernel is close to its wrapper's host
    work), the plain version with CUDA events."""
    from tcnerf_torch.ops.gather import GATHER
    from tcnerf_torch.tools import bench_gather2, bench_gather3, bench_gather4
    from tcnerf_torch.tools.common import bound_ms, graph_ms, time_ms

    results = {}
    for tool in (bench_gather2, bench_gather3, bench_gather4):
        name = tool.__name__.rsplit(".", 1)[1]
        inp = tool.make_inputs(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = tool.run(inp, dev)
        counts = read_counts()
        print(f"gather {name}: {time.perf_counter() - t0:.1f} s, launches "
              f"{counts} [{card}]")
        for case in tool.cases(inp):
            tag = f"{case.k} {name} {case.probe}"
            n_launch, err = (res[case.probe]["launches"],
                             res[case.probe]["max_abs_err"])
            if n_launch == 0:
                raise AssertionError(f"{tag}: {case.kernel} never launched")
            print(f"check {tag} {case.kernel} ({case.mode}): max_abs_err="
                  f"{err:.6g} limit=0 (bit-exact) OK")
            r = dict(err=err, launches=n_launch, name=case.kernel,
                     source=f"tcnerf_torch/csrc/{GATHER.source}",
                     replaces=tool.TPU_KERNELS[case.k],
                     mode=f"{name} {case.probe}: {case.mode}",
                     ms=graph_ms(case.call, dev),
                     plain_ms=time_ms(case.plain, dev, 3),
                     library_ms=graph_ms(case.library, dev),
                     bound=bound_ms(case.flops, case.nbytes))
            note = ""
            if case.product:
                dense, done = case.product
                r["executed_flops"] = done
                note = (f"; one-hot product dense {dense:.4g} ops "
                        f"({bound_ms(dense, 0.)[0]:.4f} ms at the bf16 "
                        f"peak), executed {done:.4g} "
                        f"({bound_ms(done, 0.)[0]:.4f} ms)")
            print(f"time {tag}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
                  f"ms, library {r['library_ms']:.4f} ms, bound "
                  f"{r['bound'][0]:.4f} ms by {r['bound'][1]}{note}) "
                  f"[{card}]")
            results.setdefault(case.k, r)       # K7's row: P1, f32
        del inp
    launches.update({k: r["launches"] for k, r in results.items()})
    return results


def phase_sweep(dev, card):
    """K1 (chain half) and K2 (fine stage) times at 1,048,576 rows over the
    number of residual blocks: the intercept is the row I/O, gather and head,
    the slope the cost of one residual block."""
    import torch
    from tcnerf_torch.ops.resmlp import pack_chain, resmlp_rows
    from tcnerf_torch.ops.swg import pack_swg, swg_field_rows
    from tcnerf_torch.tools.common import random_chain, time_ms

    gen = torch.Generator(device=dev).manual_seed(0)
    n = CHUNK * 2 * N_SAMPLES
    x = torch.randn((n, HID), generator=gen, device=dev).to(torch.bfloat16)
    img = torch.randn((H, W, HID), generator=gen, device=dev).to(torch.bfloat16)
    coords = torch.stack([torch.rand(n, generator=gen, device=dev) * (W - 1),
                          torch.rand(n, generator=gen, device=dev) * (H - 1)],
                         -1).contiguous()
    pos = torch.randn((n, 3), generator=gen, device=dev).contiguous()
    dirs = torch.randn((n, 3), generator=gen, device=dev).contiguous()
    head_k = torch.randn((120, HID), generator=gen, device=dev) * 0.09
    head_b = torch.randn((HID,), generator=gen, device=dev) * 0.1
    for nb in (0, 1, 2, 3, 6):
        w1 = random_chain(gen, nb, None, 0, dev)
        w2 = random_chain(gen, nb, None, 4, dev)
        p1 = pack_chain(w1, nb, skip_input=True, device=dev)
        p2 = pack_swg(w2, nb, head_k, head_b)
        k1 = time_ms(lambda: resmlp_rows(x, w1, nb, skip_input=True, pack=p1),
                     dev, 10)
        k2 = time_ms(lambda: swg_field_rows(img, coords, pos, dirs, w2, nb,
                                            head_k, head_b, pack=p2), dev, 10)
        print(f"sweep n_blocks={nb}: K1 {k1:.4f} ms, K2 {k2:.4f} ms [{card}]")


def build_model(dev, dtype=None, pallas_mlp=False, fusion="without",
                n_views=1, **kw):
    """A full-width stage-1 renderer, seeded weights: nerf_model/default.yaml
    (480x640, n_features 256, hidden 128, 6 blocks, 64+64 samples, near 0.3,
    far 1.3, ViT-B/16 at 224^2, hooks 3/6/9/12) with `n_views` and `fusion`
    as nerf_1_view_wo ("without", 1 view), nerf_1_view (v0, 1),
    nerf_3_view (v0, 3) or nerf_1_view_v4_elu (v4, 1, `fusion_use_dense`,
    elu) name them; the fused models add the CLIP RN50 tower (layers
    3/4/6/3, width 64, embed 1024, 32 heads, 224^2)."""
    import torch
    from tcnerf_torch.models.renderer import MVNeRFRenderer
    from tcnerf_torch.params import init_params

    model = MVNeRFRenderer(
        n_views=n_views, n_samples=N_SAMPLES, n_features=256, near=0.3,
        far=1.3, original_image_size=(H, W), fusion=fusion, n_blocks=6,
        hidden_size=HID, pallas_mlp=pallas_mlp, dtype=dtype, **kw).to(dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    return model.eval()


def reset_counts():
    from tcnerf_torch.ops.gather import GATHER
    from tcnerf_torch.ops.probe import PROBE
    from tcnerf_torch.ops.resmlp import RESMLP
    from tcnerf_torch.ops.swg import SWG
    RESMLP.counts.clear()
    SWG.counts.clear()
    GATHER.counts.clear()
    PROBE.counts.clear()


def read_counts():
    from tcnerf_torch.ops.gather import GATHER
    from tcnerf_torch.ops.probe import PROBE
    from tcnerf_torch.ops.resmlp import RESMLP
    from tcnerf_torch.ops.swg import SWG
    return {**RESMLP.counts, **SWG.counts, **GATHER.counts, **PROBE.counts}


@contextlib.contextmanager
def plain_probe(model):
    """`energy_prepared` of `model` on its plain path whatever it is given:
    the probe kernels' reference on the same card."""
    model.probe_kernel_engages = lambda poses, prepared: False
    try:
        yield
    finally:
        del model.probe_kernel_engages


def probe_engages(model) -> bool:
    """Whether the grasp path of `model` (f32 on the card) is to launch
    the probe kernels: the corner image, one view, no hash-grid stream."""
    return (model.corner_gather and model.n_views == 1
            and model.hash_cfg is None)


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


RANGE_PREFIX = "tcnerf."


def device_time_by_kernel(fn, card, top=8):
    """One call of fn under torch.profiler: device time summed by kernel
    name, and the device's busy share of the host wall time (the profiler
    slows the host side a little, so the busy share is a lower bound); then
    the port's `record_function` ranges ("tcnerf.*": encoder, CLIP tower,
    fusion, chunks) with their host and device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith(RANGE_PREFIX)), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print("profile: no device time recorded (not measured)")
        return
    print(f"profile: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}%), idle "
          f"{100 - 100 * busy / (wall * 1e3):.1f}% [{card}]")
    for ms, count, name in rows[:top]:
        print(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}% x{count:<5d} "
              f"{name[:90]}")
    for e in events:                 # the port's record_function ranges
        if e.key.startswith(RANGE_PREFIX):
            print(f"  range {e.key} ({e.device_type}): host "
                  f"{e.cpu_time_total / 1e3:.2f} ms, device "
                  f"{e.device_time_total / 1e3:.2f} ms, x{e.count}")


def scene_tensors(scene, dev):
    """A scene (a source image and its camera config, or lists of them, and
    the target's config) as `render_rays` takes it: sources [1, V, H, W, 3]
    in [0, 1], K [1, V, 4, 4], inverse extrinsics [1, V, 4, 4], then the
    target's pose and 3x3 K."""
    import numpy as np
    import torch
    from tcnerf_torch.data.generators import camera_parameters

    src, src_cfg, tgt_cfg = scene
    srcs, cfgs = (src, src_cfg) if isinstance(src, list) else ([src], [src_cfg])
    cams = [camera_parameters(c) for c in cfgs]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return (f32(np.asarray(srcs)[None] / 255.0), f32([[c[1] for c in cams]]),
            f32([[c[0] for c in cams]]), f32(tgt_cfg["pose"]),
            f32(np.reshape(tgt_cfg["intrinsics"], (3, 3))))


def middle_chunk(pose, k3, dev, seed=3):
    """The target's middle 8192 rays [1, CHUNK, 3] and seeded coarse and
    fine draws [1, CHUNK, N_SAMPLES]."""
    import torch
    from tcnerf_torch.core.rays import get_rays

    ro, rd = get_rays(W, H, pose, k3)
    sl = slice(H * W // 2, H * W // 2 + CHUNK)
    gen = torch.Generator(device=dev).manual_seed(seed)
    u_c = torch.rand((1, CHUNK, N_SAMPLES), generator=gen, device=dev)
    u_f = torch.rand((1, CHUNK, N_SAMPLES), generator=gen, device=dev)
    return (ro.reshape(-1, 3)[sl][None], rd.reshape(-1, 3)[sl][None], u_c,
            u_f)


def check_chunk(name, got, want):
    """The bf16-prepared render chunk bar: |got - want| <= 2e-2 + 3e-2
    |want| everywhere (torch.allclose; false on any NaN)."""
    import torch
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=3e-2, atol=2e-2))
    print(f"check {name}: kernel vs plain max_abs_err={err:.6g} (rtol 3e-2, "
          f"atol 2e-2: the bf16-prepared render chunk bar) "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees")


def check_swg_chunk(model, scene, dev, tag):
    """The model's feature image through the full-image swg render (finite,
    no overflow), then one 8192-ray chunk (the middle rows) through the
    kernel and its plain version at the bf16-prepared chunk bar."""
    import torch
    from tcnerf_torch.models import fused, inference

    src_t, k4, ext, pose, k3 = scene_tensors(scene, dev)
    with torch.inference_mode():
        feats, _ = model.combine_features(src_t[0])
        fine_rgb, fine_depth, n_over = inference.render_all_rays_swg(
            model, src_t, k4, ext, feats[None], pose, k3, H, W, CHUNK,
            generator=torch.Generator(device=dev).manual_seed(2))
        if not (torch.isfinite(fine_rgb).all() and torch.isfinite(fine_depth).all()):
            raise AssertionError(f"{tag} full-image render is not finite")
        if tuple(fine_rgb.shape) != (H, W, 3) or n_over != 0:
            raise AssertionError(f"{tag} full-image render: shape or overflow")
        print(f"serve {tag} full image: finite, rgb mean "
              f"{float(fine_rgb.mean()):.4f}, depth range "
              f"[{float(fine_depth.min()):.4f}, {float(fine_depth.max()):.4f}]")

        ro, rd, u_c, u_f = middle_chunk(pose, k3, dev)
        prepared = fused.swg_prepare(model, src_t, feats[None],
                                     n_blocks=model.n_blocks,
                                     dtype=torch.bfloat16)
        outs = [fused.swg_render_chunk(prepared, ro, rd, k4, ext,
                                       n_samples=N_SAMPLES,
                                       n_blocks=model.n_blocks, u_coarse=u_c,
                                       u_fine=u_f, plain=p)
                for p in (False, True)]
    for name, got, want in zip(("rgb", "depth", "fine_rgb", "fine_depth"),
                               outs[0][:4], outs[1][:4]):
        check_chunk(f"{tag} chunk {name}", got, want)


def view_fn(model, scene, dev, **kw):
    """render_view of the scene's target (seeded draws) as a call of no
    arguments."""
    import torch
    from tcnerf_torch.models import inference

    src, src_cfg, tgt_cfg = scene
    srcs, cfgs = (src, src_cfg) if isinstance(src, list) else ([src], [src_cfg])
    return lambda: inference.render_view(
        model, srcs, cfgs, tgt_cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1), **kw)


def serve_view(model, scene, dev, n_views=3, **kw):
    """render_view once (the first call), then `n_views` times with the
    counts set to 0 before each; returns (rgb, depth, first call s, view
    times s, counts of the last view)."""
    view = view_fn(model, scene, dev, **kw)
    _, t_first = timed(view)
    times = []
    for _ in range(n_views):
        reset_counts()
        (rgb, depth), t = timed(view)
        counts = read_counts()
        times.append(t)
    if rgb.shape != (H, W, 3) or depth.shape != (H, W, 1):
        raise AssertionError(f"render_view shapes {rgb.shape} {depth.shape}")
    return rgb, depth, t_first, times, counts


def phase_serve(dev, card, scene, launches):
    """render_view on the swg path (K2), then one chunk kernel vs plain."""
    model = build_model(dev)
    _, _, t_first, (t,), counts = serve_view(model, scene, dev, n_views=1)
    launches["K2"] = counts.get("swg_head_inside", 0)
    print(f"serve swg render_view {H}x{W}: {t * 1e3:.1f} ms "
          f"({H * W / t:.0f} rays/s; first call {t_first * 1e3:.1f} ms); "
          f"launches {counts} [{card}]")
    if launches["K2"] == 0:
        raise AssertionError("render_view did not launch the swg kernel")
    device_time_by_kernel(view_fn(model, scene, dev), card)

    check_swg_chunk(model, scene, dev, "swg")
    del model


def phase_serve_clip(dev, card, scene, launches):
    """nerf_1_view (fusion v0) at full width: render_view on the swg path
    (K2, as many launches as the "without" view), its steady latency, one
    profiled view split by the port's ranges, the v0 feature image through
    one chunk kernel vs plain. Then
    nerf_1_view_v4_elu (v4, elu, dense text gate) with a text embedding
    from the CLIP text tower on the card (tokenize(["a red ball"])): a
    finite view, with as many K2 launches, that differs from the
    ones-placeholder view."""
    import numpy as np
    import torch
    from tcnerf_torch.clip.model import CLIPTextualEncoder
    from tcnerf_torch.clip.tokenizer import tokenize
    from tcnerf_torch.params import init_params

    want = 2 * -(-H * W // CHUNK)
    model = build_model(dev, fusion="v0")
    rgb, _, t_first, times, counts = serve_view(model, scene, dev)
    launches["K2 v0"] = counts.get("swg_head_inside", 0)
    t = float(np.median(times))
    print(f"serve v0 swg render_view {H}x{W}: steady {t * 1e3:.1f} ms "
          f"(median of {[round(x * 1e3, 1) for x in times]}), "
          f"{H * W / t:.0f} rays/s; first call {t_first * 1e3:.1f} ms; "
          f"launches {counts} [{card}]")
    if launches["K2 v0"] != want:
        raise AssertionError(f"the v0 view launched K2 {launches['K2 v0']}"
                             f" times, not {want}")
    device_time_by_kernel(view_fn(model, scene, dev), card, top=10)
    check_swg_chunk(model, scene, dev, "v0 swg")
    del model

    model = build_model(dev, fusion="v4", fusion_use_dense=True,
                        fusion_activation="elu")
    text_tower = CLIPTextualEncoder().to(dev)
    init_params(text_tower, torch.Generator(device=dev).manual_seed(1))
    src_t = scene_tensors(scene, dev)[0]
    with torch.inference_mode():
        tokens = torch.as_tensor(tokenize(["a red ball"]), device=dev)
        text = text_tower(tokens)
        feats, _ = model.combine_features(src_t[0], clip_textuals=text)
        placeholder, _ = model.combine_features(src_t[0])
    if not (torch.isfinite(text).all() and torch.isfinite(feats).all()):
        raise AssertionError("v4 text embedding or feature image not finite")
    gap = float((feats - placeholder).abs().max())
    rgb_t, _, _, times, counts = serve_view(model, scene, dev, n_views=1,
                                            clip_textuals=text)
    n_k2 = counts.get("swg_head_inside", 0)
    rgb_1, _, _, _, _ = serve_view(model, scene, dev, n_views=1)
    diff = int((rgb_t != rgb_1).any(-1).sum())
    print(f"serve v4-elu (dense text gate) render_view {H}x{W} with the "
          f"text tower's embedding of 'a red ball' {tuple(text.shape)}: "
          f"{times[0] * 1e3:.1f} ms; features max |text - ones| {gap:.4g}; "
          f"{diff} of {H * W} pixels differ from the placeholder view; "
          f"launches {counts} [{card}]")
    if n_k2 != want:
        raise AssertionError(f"the v4-elu view launched K2 {n_k2} times, "
                             f"not {want}")
    if not gap > 0 or diff == 0:
        raise AssertionError("the text embedding does not change the view")
    del model, text_tower


def phase_serve_3view(dev, card, launches):
    """nerf_3_view (fusion v0), bf16 model, pallas_mlp: render_view on the
    flax path (K1 in both chain halves, the mean view fusion between them)
    from 3 sources of camera_ring(4) at 480x640, 8192-ray chunks; then one
    of the view's chunks through K1 and through the plain chain on the same
    weights, and K1 against the plain chain and timed at the path's four
    shapes, for its x gap."""
    import numpy as np
    import torch
    from tcnerf_torch.data.synthetic import camera_ring
    from tcnerf_torch.ops.resmlp import pack_chain, resmlp_plain, resmlp_rows
    from tcnerf_torch.tools.common import bound_ms, random_chain, time_ms

    model = build_model(dev, dtype=torch.bfloat16, pallas_mlp=True,
                        fusion="v0", n_views=3)
    cfgs = camera_ring(4, height=H, width=W)
    rng = np.random.default_rng(1)
    srcs = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(3)]
    scene = (srcs, list(cfgs[:3]), cfgs[3])
    _, _, t_first, times, counts = serve_view(model, scene, dev, n_views=1,
                                              chunk=CHUNK, use_swg=False)
    launches["K1 3-view"] = counts.get("resmlp_rows", 0)
    n_chunks = -(-H * W // CHUNK)
    print(f"serve 3-view v0 flax-path (pallas_mlp, bf16) render_view "
          f"{H}x{W}: {times[0] * 1e3:.1f} ms ({H * W / times[0]:.0f} rays/s; "
          f"first call {t_first * 1e3:.1f} ms); launches {counts} [{card}]")
    if launches["K1 3-view"] != 4 * n_chunks:
        raise AssertionError(f"the 3-view view launched K1 "
                             f"{launches['K1 3-view']} times, not "
                             f"{4 * n_chunks}")

    # the view's middle chunk with both chain halves on K1, then on the
    # plain chain (the same weights): the coarse pass at the bf16 serving
    # bar, the fine pass (its samples follow the coarse weights through the
    # PDF) at the bf16-prepared chunk bar
    src_t, k4, ext, pose, k3 = scene_tensors(scene, dev)
    ro, rd, u_c, u_f = middle_chunk(pose, k3, dev)
    embeddings = (model.coarse_embedding, model.fine_embedding)
    outs = []
    with torch.inference_mode():
        feats, _ = model.combine_features(src_t[0])
        for use_kernel in (True, False):
            for e in embeddings:
                e.use_pallas = use_kernel
            outs.append(model.render_rays(ro, rd, src_t, k4, ext, feats[None],
                                          u_coarse=u_c, u_fine=u_f))
    for name, got, want, i in zip(("rgb", "depth", "fine_rgb", "fine_depth"),
                                  outs[0], outs[1], range(4)):
        if i < 2:
            compare(f"3-view chunk {name} (K1 vs plain chain)", got, want,
                    2e-2, "bf16 model, the serving bar")
        else:
            check_chunk(f"3-view chunk {name} (K1 vs plain chain)", got, want)
    del model, feats, outs

    # K1 at the view's shapes: per chunk and stage, the first chain half on
    # 3 views' rows, the second on the fused rows (3 blocks each, bf16);
    # each against the plain chain on the same rows, then timed
    gen = torch.Generator(device=dev).manual_seed(8)
    wts = random_chain(gen, 3, None, 0, dev)
    pk = pack_chain(wts, 3, skip_input=True)
    gap, parts = 0.0, []
    for stage, s in (("coarse", N_SAMPLES), ("fine", 2 * N_SAMPLES)):
        for half, v in (("first", 3), ("second", 1)):
            n = v * CHUNK * s
            x = torch.randn((n, HID), generator=gen, device=dev
                            ).to(torch.bfloat16)
            compare(f"K1 resmlp_rows 3-view {stage} {half} half [{n}x{HID}] "
                    f"bf16", resmlp_rows(x, wts, 3, skip_input=True, pack=pk),
                    resmlp_plain(x, wts, 3, skip_input=True), 2e-2,
                    "bf16 output rounding, f32 stream")
            ms = time_ms(lambda: resmlp_rows(x, wts, 3, skip_input=True,
                                             pack=pk), dev, 10)
            b = bound_ms(2 * n * 6 * HID * HID, 2 * n * HID * 2)[0]
            gap += n_chunks * (ms - b)
            parts.append(f"{stage} {half} half [{n}x128] {ms:.4f} ms "
                         f"(bound {b:.4f})")
            del x
    print(f"time K1 on the 3-view path: {'; '.join(parts)}; x gap "
          f"{gap:.1f} ms a view ({n_chunks} chunks) [{card}]")


def phase_flax(dev, card, scene, launches):
    """render_view on the flax path with pallas_mlp (K1), bf16 model."""
    import torch
    from tcnerf_torch.models import inference

    model = build_model(dev, dtype=torch.bfloat16, pallas_mlp=True)
    src, src_cfg, tgt_cfg = scene
    reset_counts()
    (rgb, depth), t = timed(lambda: inference.render_view(
        model, [src], [src_cfg], tgt_cfg, chunk=CHUNK, use_swg=False,
        generator=torch.Generator(device=dev).manual_seed(4), device=dev))
    counts = read_counts()
    launches["K1"] = counts.get("resmlp_rows", 0)
    print(f"serve flax-path (pallas_mlp, bf16) render_view {H}x{W}: "
          f"{t * 1e3:.1f} ms ({H * W / t:.0f} rays/s, first call); "
          f"launches {counts} [{card}]")
    if launches["K1"] == 0:
        raise AssertionError("the pallas_mlp path did not launch resmlp")
    if rgb.shape != (H, W, 3):
        raise AssertionError(f"flax-path render shape {rgb.shape}")
    del model


def phase_f32(dev, card, scene, launches, n_chunks=4):
    """The f32-stream swg path (head given, K3) over a few chunks."""
    import numpy as np
    import torch
    from tcnerf_torch.models import fused
    from tcnerf_torch.core.rays import get_rays

    model = build_model(dev)
    src, src_cfg, tgt_cfg = scene
    with torch.inference_mode():
        src_t = torch.as_tensor(src[None, None] / 255.0, dtype=torch.float32,
                                device=dev)
        ext = torch.as_tensor(np.linalg.inv(src_cfg["pose"])[None, None],
                              dtype=torch.float32, device=dev)
        k4 = np.eye(4)
        k4[:3, :3] = np.reshape(src_cfg["intrinsics"], (3, 3))
        k4 = torch.as_tensor(k4[None, None], dtype=torch.float32, device=dev)
        pose = torch.as_tensor(tgt_cfg["pose"], dtype=torch.float32, device=dev)
        k3 = torch.as_tensor(np.reshape(tgt_cfg["intrinsics"], (3, 3)),
                             dtype=torch.float32, device=dev)
        ro, rd = get_rays(W, H, pose, k3)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        feats, _ = model.combine_features(src_t[0])
        prepared = fused.swg_prepare(model, src_t, feats[None],
                                     n_blocks=model.n_blocks,
                                     dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(5)
        reset_counts()

        def run():
            outs = []
            for c in range(n_chunks):
                sl = slice(c * CHUNK, (c + 1) * CHUNK)
                outs.append(fused.swg_render_chunk(
                    prepared, ro[sl][None], rd[sl][None], k4, ext,
                    n_samples=N_SAMPLES, n_blocks=model.n_blocks, fast=False,
                    generator=gen)[2])
            return torch.cat(outs, dim=1)

        rgb, t = timed(run)
    counts = read_counts()
    launches["K3"] = counts.get("swg_head_given", 0)
    print(f"serve f32-stream swg path: {n_chunks} x {CHUNK} rays in "
          f"{t * 1e3:.1f} ms ({n_chunks * CHUNK / t:.0f} rays/s, first call); "
          f"launches {counts} [{card}]")
    if launches["K3"] == 0:
        raise AssertionError("the f32 swg path did not launch the kernel")
    if not torch.isfinite(rgb).all():
        raise AssertionError("f32 swg path output is not finite")
    del model


# The trainer's configuration is nerf_1_view_wo at full width with the chain
# halves on K1' (pallas_mlp, off by default as in the JAX trainer); the
# synthetic dataset is cut to 8 scenes x 4 perspectives at 480x640, and the
# run to 4 steps (one epoch of 8 scenes at batch 8 each) and two validation
# renders.
TRAIN_CUT = ["dataset.n_perspectives=4", "dataset.n_synthetic_samples=8",
             "nerf_training.n_epochs=4", "nerf_training.eval_after_epochs=4",
             "valid_sample_idx=0", "valid_perspective_src_indices=[0]",
             "valid_perspective_tgt_idx=2", "nerf_model.pallas_mlp=true"]


def check_k1_diff_at(dev, shapes, then=None):
    """K1' (`resmlp_rows_diff`, a 3-block chain half of seeded weights, f32
    rows) at each (label, rows) of `shapes`: the forward against the plain
    chain on the same bf16 weight copies (2e-2 x max|ref|), the backward
    against autograd through the plain chain (the same code: bit for bit).
    `then(label, rows, err, x, ws, out, g, wb, pack)` runs after each
    shape's checks, with its inputs, the output and its cotangent."""
    import torch
    from tcnerf_torch.ops.resmlp import (pack_chain, resmlp_plain,
                                         resmlp_rows_diff)

    gen = torch.Generator(device=dev).manual_seed(6)
    w = []
    for _ in range(6):                  # 3 blocks of two 128x128 layers
        w += [torch.randn((HID, HID), generator=gen, device=dev) * HID ** -0.5,
              torch.randn((HID,), generator=gen, device=dev) * 0.1]
    wb = [t.to(torch.bfloat16) for t in w]
    pack = pack_chain(w, 3, skip_input=True)
    for label, n in shapes:
        x = torch.randn((n, HID), generator=gen, device=dev).requires_grad_()
        ws = [t.clone().requires_grad_() for t in w]
        out = resmlp_rows_diff(x, ws, 3, skip_input=True, pack=pack)
        err = compare(f"K1' resmlp_rows_diff forward, {label} [{n}x128] f32",
                      out, resmlp_plain(x.detach(), wb, 3, skip_input=True),
                      2e-2, "plain chain on the same bf16 weight copies")
        g = torch.randn(out.shape, generator=gen, device=dev)
        got = torch.autograd.grad(out, [x, *ws], g, retain_graph=True)
        xr = x.detach().requires_grad_()
        wr = [t.detach().requires_grad_() for t in w]
        want = torch.autograd.grad(resmlp_plain(xr, wr, 3, skip_input=True),
                                   [xr, *wr], g)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"check K1' resmlp_rows_diff backward, {label} [{n}x128]: dx "
              f"and {len(ws)} weight grads vs autograd through the plain "
              f"chain: {'bit-exact OK' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"K1' backward differs at {label}")
        if then is not None:
            then(label, n, err, x, ws, out, g, wb, pack)
        del x, ws, out, got, want


def check_k1_diff(dev, card):
    """K1' at a training chunk's shapes (128 rays x batch 8 = 1024 rays; 64
    coarse, 128 fine samples; f32 stream, a 3-block chain half), checked by
    `check_k1_diff_at`, then the kernel's forward, the plain forward and
    the backward timed. The forward is timed as a CUDA graph of launches:
    the kernel is shorter than its wrapper's host work, so events around
    back-to-back calls read the host's launch rate (printed beside it)."""
    import torch
    from tcnerf_torch.ops.resmlp import resmlp_plain, resmlp_rows
    from tcnerf_torch.tools.common import bound_ms, graph_ms, time_ms

    res = {}

    def timing(label, n, err, x, ws, out, g, wb, pack):
        xd = x.detach()

        def kernel():
            return resmlp_rows(xd, wb, 3, skip_input=True, pack=pack)

        r = res[label.split()[0]] = dict(
            err=err, n=n, ms=graph_ms(kernel, dev),
            paced_ms=time_ms(kernel, dev, 10),
            plain_ms=graph_ms(lambda: resmlp_plain(xd, wb, 3, skip_input=True),
                              dev, 5, 2),
            backward_ms=time_ms(lambda: torch.autograd.grad(
                out, [x, *ws], g, retain_graph=True), dev, 5),
            bound=bound_ms(2 * n * 6 * HID * HID, 2 * n * HID * 4))
        print(f"time K1' {label} [{n}x128]: forward (K1, CUDA graph of "
              f"20 launches) {r['ms']:.4f} ms (launch-paced, CUDA events "
              f"around back-to-back calls: {r['paced_ms']:.4f} ms), backward "
              f"(plain recompute + grads, CUDA events) {r['backward_ms']:.4f}"
              f" ms (plain forward, CUDA graph {r['plain_ms']:.4f} ms, forward "
              f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}) [{card}]")

    check_k1_diff_at(dev, [("coarse chunk", 1024 * N_SAMPLES),
                           ("fine chunk", 2048 * N_SAMPLES)], timing)
    fine = res["fine"]
    return dict(err=max(r["err"] for r in res.values()), ms=fine["ms"],
                coarse_ms=res["coarse"]["ms"], plain_ms=fine["plain_ms"],
                backward_ms=fine["backward_ms"],
                coarse_backward_ms=res["coarse"]["backward_ms"],
                bound=fine["bound"])


def train_grads(model, batch, draws, term):
    """Loss and gradients of one step's `term`: "step" (the trainer's
    chunked loss), "coarse" or "fine" (one MSE term, unchunked)."""
    from tcnerf_torch.models import training as T

    model.zero_grad(set_to_none=True)
    if term == "step":
        loss = T.nerf_loss(model, *batch, *draws)
    else:
        inputs, labels = batch
        rgb, _, fine_rgb, _, _ = model(inputs, *draws)
        loss = T.mse(labels, rgb if term == "coarse" else fine_rgb)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None}


def grad_gap(got, want):
    """Two gradients' relative L2 distance over all tensors, and per group
    of parameters (top-level module) the largest max|got - want| / max|want|
    of a tensor (tensors whose gradient is zero in exact arithmetic, below
    1e-6 of the largest, left out)."""
    import torch
    a = torch.cat([got[n].flatten() for n in want]).double()
    b = torch.cat([want[n].flatten() for n in want]).double()
    top = float(b.abs().max())
    worst = {}
    for n, w in want.items():
        scale = float(w.abs().max())
        if scale > 1e-6 * top:
            group = n.split(".")[0]
            worst[group] = max(worst.get(group, 0.0),
                               float((got[n] - w).abs().max()) / scale)
    return float((a - b).norm() / b.norm()), worst


# The full step's gradient gap through K1' may be at most this multiple of
# the larger gap of the two bf16 controls (compare_train_paths).
STEP_GAP_MULT = 1.5


def bf16_controls(model, build):
    """Two plain-chain models that make the kernel's bf16 roundings without
    the kernel, on `model`'s weights: 'rounded weights' (each chain layer's
    weight rounded to bf16) and 'kernel numerics' (the same, and each chain
    layer's input rounded to bf16 in the forward, straight through in the
    backward: the kernel's own arithmetic, whose bias and stream stay f32).
    `build()` makes a model with the plain chain."""
    import torch

    def chain(name):
        return "embedding" in name and "_block_" in name

    def round_input(_, args):
        x = args[0]
        return (x + (x.bfloat16().float() - x).detach(),)

    state = {k: v.bfloat16().float() if chain(k) and k.endswith(".weight")
             else v for k, v in model.state_dict().items()}
    controls = {}
    for tag in ("rounded weights", "kernel numerics"):
        m = build()
        m.load_state_dict(state)
        controls[tag] = m
    for name, mod in controls["kernel numerics"].named_modules():
        if chain(name) and name.endswith(("layer_0", "layer_1")):
            mod.register_forward_pre_hook(round_input)
    return controls


def compare_train_paths(kernel_model, plain_model, controls, batch, draws):
    """The repair's check: the same weights, batch and draws with
    pallas_mlp (K1') and with the plain chain.

    The step: loss within 2e-2 relative, and every parameter with a
    non-zero plain gradient gets a finite, non-zero gradient through K1'.
    Through the inverse-CDF resampling the step's gradient is
    ill-conditioned (it divides by CDF gaps down to 1e-5), so any
    bf16-sized change of the forward moves it by several percent. So the
    step's gradient gap to the plain chain (relative L2, and per group the
    worst tensor's max err / max) is held to STEP_GAP_MULT x the larger gap
    of the two `bf16_controls`; a group's worst tensor within the bf16 bar
    (2e-2) passes as well. Each parameter's gradient is also held at the
    bf16 bar, 2e-2 x max |plain grad| of the tensor (+1e-6 x the largest
    plain gradient of the term, for the gradients that are zero in exact
    arithmetic: biases before a batch-statistics norm, attention key
    biases), in a loss term whose path to it does not cross the
    resampling: the coarse MSE for the coarse field and the encoder, the
    fine MSE for the fine field."""
    import torch

    (lk, gk), (lp, gp) = (train_grads(m, batch, draws, "step")
                          for m in (kernel_model, plain_model))
    rel = abs(lk - lp) / abs(lp)
    print(f"check train step pallas_mlp vs plain chain: loss {lk:.6f} vs "
          f"{lp:.6f} (rel {rel:.3g}, limit 2e-2) "
          f"{'OK' if rel <= 2e-2 else 'FAIL'}")
    if not rel <= 2e-2:
        raise AssertionError("train loss with K1' disagrees with the plain "
                             "chain")
    dead = [n for n, want in gp.items() if float(want.abs().max()) > 0
            and (n not in gk or not torch.isfinite(gk[n]).all()
                 or not float(gk[n].abs().max()) > 0)]
    n_live = sum(float(w.abs().max()) > 0 for w in gp.values())
    print(f"check train step gradients through K1': {n_live - len(dead)} of "
          f"{n_live} parameters with a non-zero plain gradient get a finite,"
          f" non-zero one {'OK' if not dead else 'FAIL'}")
    if dead:
        raise AssertionError(f"no gradient through K1' for {dead[:5]}")
    gaps = {"K1'": grad_gap(gk, gp)}
    for tag, m in controls.items():
        gaps[tag] = grad_gap(train_grads(m, batch, draws, "step")[1], gp)
    for tag, (l2, worst) in gaps.items():
        print(f"train step gradients, {tag} vs the plain chain: relative L2 "
              f"{l2:.4g}; worst tensor max err / max per group: "
              + ", ".join(f"{g} {q:.3g}" for g, q in worst.items()))
    l2, worst = gaps["K1'"]
    ref_l2 = max(gaps[t][0] for t in controls)
    rows = [("relative L2", l2, STEP_GAP_MULT * ref_l2)]
    for g, q in worst.items():
        ref = max(gaps[t][1].get(g, 0.0) for t in controls)
        rows.append((g, q, max(STEP_GAP_MULT * ref, 2e-2)))
    bad = [f"{n} {q:.3g} > {lim:.3g}" for n, q, lim in rows if not q <= lim]
    print(f"check train step gradient gap, K1' vs the plain chain, at "
          f"{STEP_GAP_MULT} x the larger bf16 control's (per group: or "
          f"within 2e-2): " + ", ".join(f"{n} {q:.3g} / {lim:.3g}"
                                        for n, q, lim in rows)
          + (" OK" if not bad else " FAIL"))
    if bad:
        raise AssertionError("train step gradients through K1' are further "
                             "from the plain chain's than the bf16 controls"
                             " allow: " + "; ".join(bad))
    for term, prefixes in (("coarse", ("coarse_", "visual_features")),
                           ("fine", ("fine_",))):
        (_, gk), (_, gp) = (train_grads(m, batch, draws, term)
                            for m in (kernel_model, plain_model))
        floor = 1e-6 * max(float(g.abs().max()) for g in gp.values())
        worst, bad = [], []
        for name, want in gp.items():
            if not name.startswith(prefixes):
                continue
            limit = 2e-2 * float(want.abs().max()) + floor
            err = float((gk[name] - want).abs().max())
            worst.append((err / limit, name))
            if not err <= limit:
                bad.append(f"{name}: max err {err:.3g} > {limit:.3g}")
        worst.sort(reverse=True)
        print(f"check train {term}-MSE gradients pallas_mlp vs plain, "
              f"{len(worst)} parameters at 2e-2 x max|ref|: worst err/limit "
              + ", ".join(f"{n} {q:.3g}" for q, n in worst[:3])
              + (" OK" if not bad else " FAIL"))
        if bad:
            raise AssertionError(f"{term}-MSE gradients through K1' disagree:"
                                 " " + "; ".join(bad[:5]))


def phase_train(dev, card, launches, root):
    """`train_nerf._main` (the port's trainer entry) at the full nerf_1_view_wo
    width (f32, pallas_mlp + remat, 4-tap gather) on a synthetic dataset
    (TRAIN_CUT): 4 steps and two validation renders with the counts set to 0
    before and read after; its checkpoint goes under `root`. Then one
    instrumented step (K1' launches in the forward and in the backward's
    recompute), one profiled step, the encoder's forward + backward alone,
    and the K1' vs plain-chain step."""
    import numpy as np
    import torch
    from tcnerf_torch.data.generators import MVNeRFDataGenerator, to_device
    from tcnerf_torch.data.loaders import load_dataset_nerf
    from tcnerf_torch.models import training as T
    from tcnerf_torch.ops.resmlp import RESMLP
    from tcnerf_torch.tools.common import time_ms
    from tcnerf_torch.train import config, train_nerf

    kres = check_k1_diff(dev, card)
    data_dir = REPO / "build" / "chip_smoke_train"
    cfg = config.load_config([f"data_dir={data_dir}", *TRAIN_CUT,
                              f"nerf_training.model_path={root / 'train'}"],
                             "nerf_1_view_wo")
    print(f"train: nerf_1_view_wo at full width (ViT-B/16 224^2, n_features "
          f"256, hidden 128, 6 blocks, 64+64 samples, 512 rays x batch 8, "
          f"480x640 sources), f32, seeded random weights; cut: {TRAIN_CUT}")
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    (state, history), wall = timed(lambda: train_nerf._main(cfg, dev))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    launches["K1'"] = counts.get("resmlp_rows_diff", 0)
    steps = history["steps"]
    print(f"train run: {len(steps)} steps + {len(history['valid'])} "
          f"validation renders in {wall:.1f} s (dataset synthesis included); "
          f"launches {dict(counts)}; peak memory allocated "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")
    plain_data = plain_batch_seconds(cfg, dev, len(steps))
    for s, plain_s in zip(steps, plain_data):
        print(f"train step {s['step']}: loss {s['loss']:.6f}, "
              f"{s['step_s'] * 1e3:.1f} ms (waiting for the prefetched "
              f"batch {s['data_s'] * 1e3:.1f} ms; the same batch synthesized"
              f" and copied without prefetch {plain_s * 1e3:.1f} ms) [{card}]")
    if not all(np.isfinite(s["loss"]) for s in steps) or len(steps) != 4:
        raise AssertionError("train losses not finite (or not 4 steps)")
    if launches["K1'"] == 0:
        raise AssertionError("training did not launch K1'")
    steady = float(np.median([s["step_s"] for s in steps[1:4]]))
    model = state.model
    b, r = cfg.nerf_training.batch_size, cfg.nerf_model.n_rays_train
    samples = 2 * model.n_samples + model.n_samples   # coarse + fine fields
    builds = (model.coarse_embedding.pack_builds
              + model.fine_embedding.pack_builds)
    print(f"train steady step (median of steps 2-4): {steady * 1e3:.1f} ms, "
          f"{b * r / steady:.0f} rays/s, {b * r * samples / steady:.0f}"
          f" samples/s; K1 packs built {builds} times in {len(steps)} steps "
          f"(both embeddings) [{card}]")
    for epoch, value in history["valid"]:
        print(f"train validation after epoch {epoch}: PSNR {value:.3f} dB")
        if not np.isfinite(value):
            raise AssertionError("validation PSNR not finite")

    ds = load_dataset_nerf(cfg.dataset.n_perspectives,
                           f"{cfg.dataset.path}/train")
    batch = to_device(*MVNeRFDataGenerator(
        ds, n_rays_train=r, batch_size=b, n_views=1, rng=1)[0], dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    draws = T.draw_samples(model, b, r, gen, dev)
    reset_counts()
    loss = T.nerf_loss(model, *batch, *draws)
    torch.cuda.synchronize()
    n_fwd = RESMLP.counts["resmlp_rows_diff"]
    loss.backward()
    torch.cuda.synchronize()
    n_rec = RESMLP.counts["resmlp_rows_diff"] - n_fwd
    print(f"train K1' launches per step: forward {n_fwd}, backward's "
          f"recompute {n_rec} (chunk checkpoint + embedding remat)")
    device_time_by_kernel(lambda: T.nerf_train_step(state, *batch, gen),
                          card, top=10)
    flat = batch[0][2].reshape((-1,) + batch[0][2].shape[2:])
    g_out = None

    def encoder():
        nonlocal g_out
        combined, _ = model.combine_features(flat)
        if g_out is None:
            g_out = torch.randn(combined.shape, generator=gen, device=dev)
        combined.backward(g_out)

    enc_ms = time_ms(encoder, dev, 3)
    print(f"train encoder (combine_features) forward + backward alone: "
          f"{enc_ms:.1f} ms, {100 * enc_ms / (steady * 1e3):.1f}% of the "
          f"steady step [{card}]")
    del g_out
    plain_cfg = config.load_config([f"data_dir={data_dir}", *TRAIN_CUT,
                                    "nerf_model.pallas_mlp=false"],
                                   "nerf_1_view_wo")
    plain = train_nerf.build_model(plain_cfg, dev)
    plain.load_state_dict(model.state_dict())
    controls = bf16_controls(model,
                             lambda: train_nerf.build_model(plain_cfg, dev))
    compare_train_paths(model, plain, controls, batch, draws)
    return {"K1'": kres}


def plain_batch_seconds(cfg, dev, n):
    """Host seconds of the trainer's first `n` batches without the prefetch
    thread: synthesis, then the pinned copy to the card, waited for (a
    generator of the trainer's seed on its training set)."""
    import torch
    from tcnerf_torch.data.generators import MVNeRFDataGenerator, to_device
    from tcnerf_torch.data.loaders import load_dataset_nerf

    nm = cfg.nerf_model
    gen = MVNeRFDataGenerator(
        load_dataset_nerf(cfg.dataset.n_perspectives,
                          f"{cfg.dataset.path}/train"),
        n_rays_train=nm.n_rays_train, batch_size=cfg.nerf_training.batch_size,
        n_views=nm.n_views, shuffle=True, rng=cfg.get("seed", 0))
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        to_device(*gen[i % len(gen)], dev)
        torch.cuda.synchronize(dev)
        out.append(time.perf_counter() - t0)
    return out


def read_png(path):
    """An 8-bit RGB PNG written without filters (train_nerf.write_png) as
    an [H, W, 3] uint8 array, with the stdlib: the chunk CRCs checked."""
    import struct
    import zlib

    import numpy as np

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 2):
        raise AssertionError(f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3)


# K1' at the fused trainers' shapes (64 coarse, 128 fine samples a ray): the
# batch-1 steps' unchunked 512 rays; the 3-view step's 128-ray chunks of
# batch 8, whose first chain half runs on 3 views' rows; the 3-view
# validation render's 512-ray chunks (forward only there, f32 rows: K1).
FUSED_K1_SHAPES = [("1-view batch-1 step coarse", 512 * 64),
                   ("1-view batch-1 step fine", 512 * 128),
                   ("3-view step first half coarse", 1024 * 64 * 3),
                   ("3-view step first half fine", 1024 * 128 * 3),
                   ("3-view validation first half coarse", 512 * 64 * 3)]


# The fused stage-1 configs at full width, each on a synthetic dataset of
# 480x640 renders with 4 perspectives: the batch-1 configs on 4 scenes (4
# steps in one epoch), nerf_3_view (batch 8) on phase_train's 8 scenes (3
# epochs of 1 step); the chain halves on K1' (pallas_mlp).
FUSED_TRAIN = [
    ("nerf_1_view", ["dataset.path=${data_dir}/fused1",
                     "dataset.n_synthetic_samples=4",
                     "nerf_training.n_epochs=1",
                     "nerf_training.eval_after_epochs=1",
                     "valid_perspective_src_indices=[0]"]),
    ("nerf_1_view_v4_elu", ["dataset.path=${data_dir}/fused1",
                            "dataset.n_synthetic_samples=4",
                            "nerf_training.n_epochs=1",
                            "nerf_training.eval_after_epochs=1",
                            "valid_perspective_src_indices=[0]"]),
    ("nerf_3_view", ["dataset.n_synthetic_samples=8",
                     "nerf_training.n_epochs=3",
                     "nerf_training.eval_after_epochs=3",
                     "valid_perspective_src_indices=[0,1,3]"]),
]
FUSED_COMMON = ["dataset.n_perspectives=4", "valid_sample_idx=0",
                "valid_perspective_tgt_idx=2", "nerf_model.pallas_mlp=true"]


def phase_train_fused(dev, card, launches, root):
    """K1' at the fused paths' shapes (FUSED_K1_SHAPES), then
    `train_nerf._main` on each FUSED_TRAIN config at full width (f32,
    pallas_mlp + remat, 4-tap gather, the frozen CLIP RN50 tower, V0 or
    the v4-elu decoder), the counts set to 0 before each run and read
    after: finite losses, the frozen tower's weights unchanged, the
    validation strips decode. Then per config one instrumented step (K1'
    launches), one instrumented validation render (K2 on 1 view, K1 on 3
    views) and one profiled step. Each run stores its checkpoint under
    `root/<config>`; returns a CPU copy of the v4-elu run's final backbone
    and decoder, which `phase_checkpoint` loads into the language stage."""
    import numpy as np
    import torch
    from tcnerf_torch.data.generators import MVNeRFDataGenerator, to_device
    from tcnerf_torch.data.loaders import load_dataset_nerf
    from tcnerf_torch.models import training as T
    from tcnerf_torch.train import config, train_nerf

    check_k1_diff_at(dev, FUSED_K1_SHAPES)
    data_dir = REPO / "build" / "chip_smoke_train"
    finals = {}
    for name, cut in FUSED_TRAIN:
        cfg = config.load_config(
            [f"data_dir={data_dir}", *FUSED_COMMON, *cut,
             f"nerf_training.model_path={root / name}"], name)
        nm, nt = cfg.nerf_model, cfg.nerf_training
        print(f"train {name}: fusion {nt.fusion}, {nm.n_views} view(s), "
              f"batch {nt.batch_size} x {nm.n_rays_train} rays, full width "
              f"(ViT-B/16, CLIP RN50, n_features 256, hidden 128, 6 blocks, "
              f"480x640), f32, seeded random weights; cut: "
              f"{FUSED_COMMON + cut}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        (state, history), wall = timed(lambda: train_nerf._main(cfg, dev))
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        tag = name.replace("nerf_", "")
        launches[f"K1' train_{tag}"] = counts.get("resmlp_rows_diff", 0)
        steps = history["steps"]
        print(f"train {name} run: {len(steps)} steps + "
              f"{len(history['valid'])} validation renders in {wall:.1f} s "
              f"(dataset synthesis included); launches {dict(counts)}; peak "
              f"memory allocated {peak / 2 ** 30:.2f} GiB [{card}]")
        for s in steps:
            print(f"train {name} step {s['step']}: loss {s['loss']:.6f}, "
                  f"{s['step_s'] * 1e3:.1f} ms (waiting for the prefetched "
                  f"batch {s['data_s'] * 1e3:.1f} ms) [{card}]")
        if len(steps) < 2 or not all(np.isfinite(s["loss"]) for s in steps):
            raise AssertionError(f"{name}: losses not finite (or < 2 steps)")
        if launches[f"K1' train_{tag}"] == 0:
            raise AssertionError(f"{name}: training did not launch K1'")
        steady = float(np.median([s["step_s"] for s in steps[1:]]))
        rays = nt.batch_size * nm.n_rays_train
        print(f"train {name} steady step (median of steps 2-{len(steps)}): "
              f"{steady * 1e3:.1f} ms, {rays / steady:.0f} rays/s [{card}]")
        for epoch, value in history["valid"]:
            strip = read_png(Path(nt.model_path) / "valid"
                             / f"valid-{epoch}.png")
            print(f"train {name} validation after epoch {epoch}: PSNR "
                  f"{value:.3f} dB, strip {strip.shape} decoded")
            if strip.shape != (H, (nm.n_views + 3) * W, 3):
                raise AssertionError(f"{name}: strip shape {strip.shape}")
            if not np.isfinite(value):
                raise AssertionError(f"{name}: validation PSNR not finite")

        model = state.model
        if name == "nerf_1_view_v4_elu":
            finals = {c: {k: v.detach().cpu().clone() for k, v in
                          getattr(model, c).state_dict().items()}
                      for c in ("fine_embedding", "visual_features",
                                "combine_clip_visual")}
        fresh = train_nerf.build_model(cfg, dev)
        same = all(torch.equal(p, q) for (n, p), (_, q) in zip(
            model.named_parameters(), fresh.named_parameters())
            if T.param_group(n) == "frozen")
        moved = any(not torch.equal(p, q) for (n, p), (_, q) in zip(
            model.named_parameters(), fresh.named_parameters())
            if T.param_group(n) == "nerf")
        n_frozen = sum(T.param_group(n) == "frozen"
                       for n, _ in model.named_parameters())
        no_grad = all(p.grad is None for n, p in model.named_parameters()
                      if T.param_group(n) == "frozen")
        print(f"check train {name} frozen CLIP tower: {n_frozen} tensors "
              f"bit-identical to the seeded ones after {len(steps)} steps and"
              f" without gradients; the nerf group moved: "
              f"{'OK' if same and moved and no_grad else 'FAIL'}")
        if not (same and moved and no_grad and n_frozen):
            raise AssertionError(f"{name}: frozen tower changed or got "
                                 "gradients, or the nerf group did not train")
        del fresh

        ds = load_dataset_nerf(cfg.dataset.n_perspectives,
                               f"{cfg.dataset.path}/train")
        batch = to_device(*MVNeRFDataGenerator(
            ds, n_rays_train=nm.n_rays_train, batch_size=nt.batch_size,
            n_views=nm.n_views, rng=1)[0], dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        reset_counts()
        T.nerf_train_step(state, *batch, gen)
        torch.cuda.synchronize(dev)
        per_step = read_counts().get("resmlp_rows_diff", 0)
        valid = train_nerf.load_validation(cfg, load_dataset_nerf(
            cfg.dataset.n_perspectives, f"{cfg.dataset.path}/valid"))
        reset_counts()
        _, t_valid = timed(lambda: train_nerf.run_validation(
            model, valid, dev, gen, str(data_dir / f"valid-{tag}.png")))
        per_render = read_counts()
        print(f"train {name} launches: K1' {per_step} per step (forward + "
              f"the backward's recompute); one validation render "
              f"{t_valid * 1e3:.1f} ms with {dict(per_render)} [{card}]")
        if nm.n_views == 1:
            launches[f"K2 valid_render_{tag}"] = per_render.get(
                "swg_head_inside", 0)
        else:
            launches[f"K1 valid_render_{tag}"] = per_render.get(
                "resmlp_rows", 0)
        if not (per_render.get("swg_head_inside", 0)
                or per_render.get("resmlp_rows", 0)):
            raise AssertionError(f"{name}: the validation render launched "
                                 "no kernel")
        device_time_by_kernel(lambda: T.nerf_train_step(state, *batch, gen),
                              card, top=8)
        del state, model, batch, history
    return finals


def grasp_scene(n_images, seed):
    """`n_images` 480x640 views from a camera_ring around the workspace's
    centre, seeded random images: (images [1, n, H, W, 3] in [0, 1],
    intrinsics [1, n, 4, 4], inverse extrinsics)."""
    import numpy as np
    from tcnerf_torch.data.synthetic import camera_ring

    cfgs = camera_ring(n_images, height=H, width=W)
    k4 = np.tile(np.eye(4, dtype=np.float32), (n_images, 1, 1))
    k4[:, :3, :3] = [c["intrinsics"].reshape(3, 3) for c in cfgs]
    ext = np.asarray([np.linalg.inv(c["pose"]) for c in cfgs], np.float32)
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(1, n_images, H, W, 3)).astype(np.float32)
    return images, k4[None], ext[None]


def relu_sides(n, take=None):
    """A torch-function mode that records, for each relu of the calls
    under it, which side of 0 each input entry lies on (`.sides`, bool
    tensors on the CPU in the input's layout). Every relu input on the
    grasp energy's path is [batch, n guesses, ...] (held unless `n` is
    None, which records every relu, the encoder's too). With `take`, the
    sides recorded by an earlier run of the same calls, each relu takes
    those branches instead of its own: x where that run's input was > 0,
    else 0 (and the gradient follows)."""
    import torch
    from torch.overrides import TorchFunctionMode

    relus = (torch.relu, torch.nn.functional.relu, torch.Tensor.relu)

    class Sides(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.sides = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func not in relus:
                return func(*args, **(kwargs or {}))
            x = args[0]
            if n is not None and (x.dim() < 2 or x.shape[1] != n):
                raise AssertionError(f"a relu input of shape "
                                     f"{tuple(x.shape)}: no guess axis")
            self.sides.append((x.detach() > 0).cpu())
            if take is None:
                return func(*args, **(kwargs or {}))
            side = take[len(self.sides) - 1]
            if side.shape != x.shape:
                raise AssertionError("the relus ran in another order")
            return torch.where(side.to(x.device), x, torch.zeros_like(x))

    return Sides()


def per_guess(sides, n):
    """relu sides [batch, n, ...] -> [n, all entries of all relus]."""
    import torch
    return torch.cat([x.transpose(0, 1).reshape(n, -1) for x in sides], 1)


def grasp_energy_grads(model, opt, scene, features, guesses, take=None):
    """Energies and d(sum E)/d(t, r) of `guesses` with `model` (on its
    device and dtype) in the folded scene, and the branches the gradient
    took, as CPU tensors: each probe's bilinear cell in each image [n, ...]
    (per pixel axis the stencil's clamped floor, or -1 / size outside the
    grid, where the clamp cuts the derivative) and the side of 0 of every
    relu input (`relu_sides`; with `take`, the relus take those sides).
    The gradient jumps where a branch changes."""
    import torch
    from tcnerf_torch.core import se3
    from tcnerf_torch.core.projection import project_probe_points
    from tcnerf_torch.opt.pose_optimizer import PoseOptimizer, frozen

    o = PoseOptimizer(model=model, workspace_bounds=opt.workspace_bounds,
                      n_images=opt.n_images, n_views=opt.n_views,
                      rotation_representation=opt.rotation_representation)
    sc = o.prepare(scene, features.to(device=o.device, dtype=o.dtype))
    st = o.init_state(guesses)
    t = st.translations.requires_grad_()
    r = st.rotations.requires_grad_()
    n = t.shape[1]
    with frozen(model):
        with relu_sides(n, take) as sides:
            e = o._energies(t, r, sc)
        g = torch.autograd.grad(e.sum(), [t, r])
    with torch.no_grad():             # the coordinates energy_prepared uses
        b = o.batch_size
        poses = se3.pose_to_matrix(t.expand(b, -1, -1), r.expand(b, -1, -1),
                                   o.rotation_representation)
        probes = torch.einsum("bnij,pjk->bnpik", poses,
                              model.probes.to(poses.dtype))
        xy, _ = project_probe_points(probes[..., :3, 3], sc.intrinsics,
                                     sc.extrinsics_inv)
        image = (sc.prepared.corner if sc.prepared.corner is not None
                 else sc.prepared.combined)
        size = torch.tensor(image.shape[2:0:-1], device=xy.device,
                            dtype=xy.dtype)              # (W, H)
        cell = torch.clamp(torch.floor(xy), max=size - 2)
        cell = torch.where(xy < 0, -1.0, torch.where(xy > size - 1, size,
                                                     cell))
        cell = cell.reshape(-1, n, model.n_probes, 2).transpose(0, 1)
    return dict(e=e.detach().cpu(), dt=g[0][0].cpu(), dr=g[1][0].cpu(),
                cells=cell.reshape(n, -1).cpu(), sides=sides.sides)


def check_grasp_on_cpu(opt, scene, features, tag, n=64):
    """`n` seeded guesses on the card against the same model on the CPU,
    from the card's features, each error against max |cpu|. The card runs
    the plain path (`plain_probe`) there, and its grasp path (the probe
    kernels, where they engage) is held against that: energies within
    1e-4, gradients within 1e-3.

    The f32 energies within 1e-3. The f32 d(sum E)/d(t, r) within 1e-3,
    against the CPU run made to take the card's relu branches, for every
    guess whose probes fall in the same bilinear cells on both (at most
    n / 4 do not): the gradient jumps where a branch changes, and the two
    devices' f32 roundings can put an entry on either side. Against the
    CPU's own branches, the median error of all entries within 1e-4, and
    the entries beyond 1e-3 are counted with the guesses whose branches
    differ. Then energies and gradients of f64 copies of both models
    within 1e-3."""
    import copy

    import torch

    model = opt.model
    guesses = opt.generate_initial_guesses(5, n)
    cpu = copy.deepcopy(model).cpu()
    with plain_probe(model):
        got = grasp_energy_grads(model, opt, scene, features, guesses)
    own = grasp_energy_grads(cpu, opt, scene, features, guesses)
    want = grasp_energy_grads(cpu, opt, scene, features, guesses,
                              take=got["sides"])
    compare(f"grasp {tag} f32 energies of {n} guesses, card vs CPU",
            got["e"], own["e"], 1e-3, "the same model and features on the "
            "CPU")
    cells = (got["cells"] != own["cells"]).any(dim=1)            # [n]
    flips = per_guess(got["sides"], n) != per_guess(own["sides"], n)
    relus = flips.any(dim=1)
    k = int(cells.sum())
    print(f"grasp {tag} f32 branches of {n} guesses, card vs CPU: {k} "
          f"guesses with a probe in another bilinear cell (limit {n // 4}); "
          f"{int(relus.sum())} with a relu input on the other side of 0 "
          f"({int(flips.sum())} of {flips.numel()} relu inputs)")
    for what in ("dt", "dr"):
        g, w, o = got[what], want[what], own[what]
        scale = float(o.abs().max())
        held = float((g - w).abs()[~cells].max()) if k < n else 0.0
        err = (g - o).abs()
        beyond = (err > 1e-3 * scale).any(dim=1)
        median = float(err.median()) / scale
        ok = k <= n // 4 and held <= 1e-3 * scale and median <= 1e-4
        print(f"check grasp {tag} f32 dE/d{what[1]} of {n} guesses, card vs "
              f"CPU: the {n - k} guesses in the same cells, the CPU on the "
              f"card's relu branches: max_abs_err={held:.6g} limit="
              f"{1e-3 * scale:.6g} (1e-3 x max|ref| {scale:.6g}); the CPU on"
              f" its own branches: max err {float(err.max()):.6g}, "
              f"{int(beyond.sum())} guesses beyond 1e-3 x max|ref|, "
              f"{int((beyond & (relus | cells)).sum())} of them with a "
              f"branch changed, median err {median:.3g} x max|ref| (limit "
              f"1e-4) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grasp {tag} f32 dE/d{what[1]}: card and "
                                 "CPU disagree")
    del cpu
    kern = grasp_energy_grads(model, opt, scene, features, guesses)
    for what, label, tol in (("e", "energies", 1e-4), ("dt", "dE/dt", 1e-3),
                             ("dr", "dE/dr", 1e-3)):
        compare(f"grasp {tag} f32 {label} of {n} guesses, the grasp path "
                f"vs the plain path on the card", kern[what], got[what], tol,
                "the probe kernels where they engage; f32 roundings can "
                "put a relu input on the other side of 0")
    runs = [grasp_energy_grads(m, opt, scene, features, guesses)
            for m in (copy.deepcopy(model).double(),
                      copy.deepcopy(model).cpu().double())]
    for what, label in (("e", "energies"), ("dt", "dE/dt"), ("dr", "dE/dr")):
        compare(f"grasp {tag} f64 {label} of {n} guesses, card vs CPU",
                runs[0][what], runs[1][what], 1e-3,
                "f64 copies of the model, the card's features")
    torch.cuda.empty_cache()


def phase_grasp(dev, card, name="goal_1_view", text=None, fusion=None,
                sync=True, model_dir=None, trained=None, launches=None):
    """`GraspPipeline.infer` on `name` at full width (ViT-B/16 224^2,
    n_features 256, hidden 128, 6 blocks, 480x640; 7 5-d poses = 42
    probes; the language config adds the CLIP RN50 and text towers and the
    v4-elu decoder): 4096 guesses, 3 images from a camera ring, the
    validation/grasp_opt_config/3_images schedule (16 steps, lr 0.05 /
    0.05, decay 0.9 / 0.09, translations clipped to the
    generator_grasp/default workspace), synchronized or alternating.
    Checks: finite energies; the returned top-k scores equal a fresh
    `energy` of the returned poses; 64 guesses' energies and pose
    gradients on the card against the CPU; the measured infer's probe
    kernel launches (P1 a forward for each step and the final energies, P2
    a backward for each step, where `probe_engages`; else none), recorded
    in `launches` under "P1" / "P2" (goal_1_view) or "P1 <name>". Prints
    the encode ms, the ms per ascent step and of the final energies, both
    beside the plain path's (`plain_probe`), the infer wall, guesses x
    steps / s, the peak memory and one profiled ascent step. With
    `model_dir` the pipeline is
    `GraspPipeline.from_checkpoints` of that grasp run's `model_final` on
    a seeded model, whose grasp components must then equal `trained` (a
    state dict) bit for bit."""
    import numpy as np
    import torch
    from tcnerf_torch.models.pipeline import GraspPipeline
    from tcnerf_torch.tools.common import time_ms
    from tcnerf_torch.train import config
    from tcnerf_torch.train.grasp_common import build_grasp_model

    cfg = config.load_config([], name)
    oc = cfg.validation.grasp_opt_config
    opt_cfg, sched = oc.optimizer_config, oc.optimization_config
    rep = cfg.grasp_model.get("rotation_representation", "quaternion")
    model = build_grasp_model(cfg, fusion=fusion, device=dev)
    workspace = cfg.generator_grasp.workspace_bounds
    make = (functools.partial(GraspPipeline, params=None)
            if model_dir is None else functools.partial(
                GraspPipeline.from_checkpoints, model_dir=str(model_dir)))
    pipe = make(
        model=model, workspace_bounds=workspace,
        n_initial_guesses=opt_cfg.n_initial_guesses,
        n_images=opt_cfg.n_images, rotation_representation=rep,
        clip_translation=opt_cfg.clip_translation,
        n_optimization_steps=sched.n_optimization_steps,
        init_lr_t=sched.init_lr_t, init_lr_r=sched.init_lr_r,
        decay_t=sched.decay_t, decay_r=sched.decay_r, sync=sync)
    if trained is not None:
        from tcnerf_torch.models import checkpoint as ckpt
        got = model.state_dict()
        keys = [k for k in got if k.split(".", 1)[0] in ckpt.GRASP_COMPONENTS]
        bad = [k for k in keys if not torch.equal(got[k], trained[k])]
        print(f"check grasp {name} from_checkpoints: {len(keys) - len(bad)}"
              f" of {len(keys)} tensors of the grasp components (hash_tables"
              f" {'hash_tables' in keys}) bit for bit the trained model's "
              f"{'OK' if keys and not bad else 'FAIL'}")
        if bad or not keys:
            raise AssertionError(f"grasp {name}: from_checkpoints restored "
                                 f"other tensors, e.g. {bad[:3]}")
    scene = grasp_scene(opt_cfg.n_images, seed=2)
    n, steps = opt_cfg.n_initial_guesses, sched.n_optimization_steps
    n_steps = steps * (1 if sync else 2)
    print(f"grasp {name}: {n} guesses x {n_steps} steps "
          f"({'synchronized' if sync else 'alternating t / r'}), "
          f"{opt_cfg.n_images} images, {model.n_probes} probes, {rep}, "
          f"readout {cfg.grasp_training.get('readout_flavor', 'dngf')} "
          f"flavour"
          + (f", prompt {text!r}" if text else "") + "; seeded weights")
    _, t_first = timed(lambda: pipe.infer(*scene, text=text, rng=0))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    result, t_infer = timed(lambda: pipe.infer(*scene, text=text, rng=0))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    got = (counts.get("probe_fwd", 0), counts.get("probe_bwd", 0))
    engages = probe_engages(model)
    want = (n_steps + 1, n_steps) if engages else (0, 0)
    why = ("the corner image, one view, no hash-grid stream" if engages
           else "the plain path")
    print(f"check grasp {name} probe kernel launches in one infer: P1 "
          f"{got[0]}, P2 {got[1]} (want {want[0]}, {want[1]}: {why}) "
          f"{'OK' if got == want else 'FAIL'}")
    if got != want:
        raise AssertionError(f"grasp {name}: probe kernel launches {got}, "
                             f"not {want}")
    if launches is not None:
        suffix = "" if name == "goal_1_view" else f" {name}"
        launches[f"P1{suffix}"], launches[f"P2{suffix}"] = got
    energies = result.all_energies
    if energies.shape != (n,) or not np.isfinite(energies).all():
        raise AssertionError(f"grasp {name}: energies {energies.shape} not "
                             "finite")
    enc_ms = time_ms(lambda: pipe.encode(scene[0], text), dev, 3)
    opt = pipe._ensure_optimizer()
    features = pipe.encode(scene[0], text)
    sc, t_prepare = timed(lambda: opt.prepare(scene, features))
    guesses, t_guess = timed(lambda: opt.generate_initial_guesses(0))
    state = opt.init_state(guesses)
    _, t_results = timed(lambda: opt.get_results(state))
    # the schedule infer runs: one phase of t and r, or a t phase then an
    # r phase
    phases = [(True, True)] if sync else [(True, False), (False, True)]
    names = {(True, True): "t and r", (True, False): "t only",
             (False, True): "r only"}
    step_ms = {names[ph]: time_ms(
        lambda ph=ph: opt.optimize_pose(state, sc, ph, 1), dev, 5)
        for ph in phases}
    final_ms = time_ms(lambda: opt.compute_current_grasp_success(state, sc),
                       dev, 5)
    with plain_probe(model):
        plain_step_ms = {names[ph]: time_ms(
            lambda ph=ph: opt.optimize_pose(state, sc, ph, 1), dev, 3)
            for ph in phases}
        plain_final_ms = time_ms(
            lambda: opt.compute_current_grasp_success(state, sc), dev, 3)
    ascent_ms = time_ms(lambda: [opt.optimize_pose(state, sc, ph, steps)
                                 for ph in phases], dev, 1)
    print(f"grasp {name} infer: {t_infer * 1e3:.1f} ms wall (first call "
          f"{t_first * 1e3:.1f} ms; the pipeline's own duration "
          f"{result.duration_s * 1e3:.1f} ms); encode {enc_ms:.1f} ms; one "
          f"ascent step " + ", ".join(f"({k}) {v:.2f} ms"
                                      for k, v in step_ms.items())
          + f" (CUDA events, {n} guesses x "
          f"{opt_cfg.n_images} images x {model.n_probes} probes = "
          f"{n * opt_cfg.n_images * model.n_probes} probe rows; the plain "
          f"path's " + ", ".join(f"({k}) {v:.2f} ms"
                                 for k, v in plain_step_ms.items())
          + f"); final energies {final_ms:.2f} ms (the plain path's "
          f"{plain_final_ms:.2f} ms); "
          f"{n_steps} steps as infer runs them {ascent_ms:.1f} ms = "
          f"{n * n_steps / (ascent_ms / 1e3):.0f} guesses x steps / s; peak "
          f"memory allocated {peak / 2 ** 30:.2f} GiB; top scores "
          f"{[round(x, 4) for x in result.scores]} [{card}]")
    print(f"grasp {name} infer parts: prepare the scene (corner image) "
          f"{t_prepare * 1e3:.1f} ms, {n} initial guesses on the host "
          f"(Affine.random, numpy + scipy) {t_guess * 1e3:.1f} ms, "
          f"get_results ({n} Affine) {t_results * 1e3:.1f} ms [{card}]")

    # the returned top-k scores against a fresh energy of the returned poses
    def fold(x):
        x = torch.as_tensor(x, device=dev)
        return x.reshape((opt.batch_size, opt.n_views) + tuple(x.shape[2:]))

    poses = torch.as_tensor(np.asarray([p.matrix for p in result.poses],
                                       np.float32), device=dev)
    with torch.no_grad():
        fresh = model.energy(poses[None].expand(opt.batch_size, -1, -1, -1),
                             fold(scene[0]), sc.intrinsics, sc.extrinsics_inv,
                             fold(features)).sum(0)
    compare(f"grasp {name} top-{len(result.scores)} scores vs a fresh energy"
            f" of the returned poses", torch.tensor(result.scores),
            fresh.cpu(), 1e-4, "the same model, poses through Affine")
    check_grasp_on_cpu(opt, scene, features, name)
    for ph in phases:
        print(f"grasp {name} profiled ascent step ({names[ph]}):")
        device_time_by_kernel(lambda: opt.optimize_pose(state, sc, ph, 1),
                              card, top=8)
    del pipe, model, opt, sc, features
    return dict(infer_ms=t_infer * 1e3, step_ms=step_ms, encode_ms=enc_ms)


def phase_grasp_language(dev, card, launches=None):
    """phase_grasp on language_1_view: fusion v4 (dense text gate, elu),
    6d rotations, the dngf readout with bias, the prompt through the port's
    tokenizer and the CLIP text tower, alternating t / r phases."""
    return phase_grasp(dev, card, "language_1_view",
                       text="grasp the red ball", fusion="v4", sync=False,
                       launches=launches)


# (config, trainer module, its run function, fusion, dataset kind); the
# delta-NGF and trajectory trainers read one "grad" dataset
GRASP_TRAIN = [
    ("goal_1_view", "train_goal", "run_goal_training", None, "goal"),
    ("dngf_1_view", "train_delta_ngf", "run_delta_training", None, "grad"),
    ("trajectory_1_view-2", "train_trajectory", "run_trajectory_training",
     None, "grad"),
    ("language_1_view", "train_language", "run_language_training", "v4",
     "language"),
]
GRASP_TRAIN_CUT = ["grasp_training.n_epochs=2",
                   "grasp_training.eval_after_epochs=1"]
GRASP_TRAIN_EXTRA = {"language_1_view": ["dataset.n_perspectives=5"]}
# the chain kernels' counters: none of them lies on the grasp trainers' path
CHAIN_COUNTS = {"K1": "resmlp_rows", "K1'": "resmlp_rows_diff",
                "K2": "swg_head_inside", "K3": "swg_head_given"}


def _moved(batch, dev, dtype=None):
    """A numpy batch (nested lists / tuples) as tensors on `dev` (floats in
    `dtype` when given)."""
    import numpy as np
    import torch
    if isinstance(batch, (list, tuple)):
        return [_moved(x, dev, dtype) for x in batch]
    t = torch.as_tensor(np.asarray(batch), device=dev)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def grasp_train_grads(base, name, inputs, labels, dev, dtype, take=None,
                      trainable=("grasp_readout",)):
    """One step's metrics and the `trainable` components' gradients (before
    clipping, flat, f64 on the CPU) of a copy of `base` on `dev` in
    `dtype`: the goal step (kl_divergence, mean) for goal_1_view, the
    delta-NGF step (cross-entropy, quaternions) otherwise; and the sides of
    0 of every relu input (`relu_sides`; with `take` the relus take
    those)."""
    import copy

    import torch
    from tcnerf_torch.models import grasp_training as GT

    m = copy.deepcopy(base).to(device=dev, dtype=dtype)
    state = GT.create_grasp_train_state(m, trainable=trainable)
    i, lab = _moved(inputs, dev, dtype), _moved(labels, dev, dtype)
    with relu_sides(None, take) as sides:
        if name == "goal_1_view":
            metrics, grads = GT.grasp_gradients(state, i, lab,
                                                "kl_divergence")
        else:
            metrics, grads = GT.delta_ngf_gradients(state, i, lab)
    return ({k: float(v) for k, v in metrics.items()},
            torch.cat([g.detach().reshape(-1).double().cpu() for g in grads]),
            sides.sides)


def check_grasp_train_on_cpu(dev, card, data_dir,
                             names=("goal_1_view", "dngf_1_view"),
                             trainable=("grasp_readout",), own_tol=1e-3):
    """One goal step (kl_divergence, mean) and one delta-NGF step
    (dngf_1_view, or `names`' other configs: cross-entropy, quaternions)
    of one sample with 64 landscape (and 64 gradient) poses at full width,
    on the card against the same model on the CPU, from the same seeded
    weights and batch. f64 on both sides: the metrics and the `trainable`
    components' gradients before clipping within 1e-8 relative (of max
    |cpu| for the gradients). f32: at most
    1e-5 of the relu inputs on the other side of 0 on card and CPU; the
    metrics within 1e-4 relative of the CPU run made to take the card's
    relu branches (the delta-NGF losses are functions of the pose
    gradient, which jumps where a relu input changes side: ROADMAP Queue
    C) and within `own_tol` (1e-3; None: printed, not held) relative of
    the CPU's own run; and of the gradients
    against the CPU's own branches, fewer than 1% of the entries beyond
    1e-3 x max |cpu| and the median error below 1e-4 x max |cpu| (the
    count is printed)."""
    import torch
    from tcnerf_torch.data.generators import (DeltaNGFDataGenerator,
                                              GraspMVNeRFDataGenerator)
    from tcnerf_torch.data.loaders import load_dataset, load_dataset_baseline
    from tcnerf_torch.train import config
    from tcnerf_torch.train.grasp_common import build_grasp_model

    cpu = torch.device("cpu")
    for name in names:
        cfg = config.load_config([], name)
        ws = cfg.generator_grasp.workspace_bounds
        if name == "goal_1_view":
            gen = GraspMVNeRFDataGenerator(
                load_dataset_baseline(str(data_dir / "goal"), 5, "train"),
                ws, n_points_train=64, batch_size=1, n_r_fraction=32, rng=3)
        else:
            gen = DeltaNGFDataGenerator(
                load_dataset(str(data_dir / "grad"), 5, True, True, "train"),
                ws, batch_size=1, pose_augmentation_factor=16,
                n_future_poses=4, rng=3)
        batch = gen[0]
        base = build_grasp_model(cfg, device=dev)
        for dtype in (torch.float64, torch.float32):
            f64 = dtype == torch.float64
            mg, gg, sides = grasp_train_grads(base, name, *batch, dev, dtype,
                                              trainable=trainable)
            mc, gc, own = grasp_train_grads(base, name, *batch, cpu, dtype,
                                            trainable=trainable)
            if f64:
                m64 = mg
            held = mc
            if not f64:
                held = grasp_train_grads(base, name, *batch, cpu, dtype,
                                         take=sides, trainable=trainable)[0]
                flips = sum(int((a != b).sum()) for a, b in zip(sides, own))
                total = sum(a.numel() for a in sides)
                ok = flips <= 1e-5 * total
                print(f"check grasp train {name} f32 relu inputs on the other"
                      f" side of 0, card vs CPU: {flips} of {total} (limit "
                      f"1e-5 of them) {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"grasp train {name}: the relus of "
                                         "card and CPU took other branches")
            tol = 1e-8 if f64 else 1e-4
            for k, v in held.items():
                rel = abs(mg[k] - v) / abs(v)
                # f32, the CPU on its own branches: the cosine losses read
                # the pose gradient, which jumps where a relu input changes
                # side and is ill-conditioned in f32 (the port's f32 bar)
                own_rel = 0.0 if f64 else abs(mg[k] - mc[k]) / abs(mc[k])
                ok = rel <= tol and (own_tol is None or own_rel <= own_tol)
                own_err = ("" if f64 else f"; the CPU on its own branches: "
                           f"{mc[k]:.10g}, err {own_rel:.3g} relative (limit "
                           f"{own_tol or 'none: printed'}); f32 from the f64 "
                           f"value: card "
                           f"{abs(mg[k] - m64[k]) / abs(m64[k]):.3g}, CPU "
                           f"{abs(mc[k] - m64[k]) / abs(m64[k]):.3g} "
                           f"relative")
                print(f"check grasp train {name} {str(dtype)[6:]} {k}, card "
                      f"vs CPU{'' if f64 else ' on the card relu branches'}:"
                      f" card {mg[k]:.10g} cpu {v:.10g} err {rel:.3g} "
                      f"relative (limit {tol}){own_err} "
                      f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"grasp train {name} {k}: card and "
                                         "CPU disagree")
            scale = float(gc.abs().max())
            err = (gg - gc).abs()
            if f64:
                compare(f"grasp train {name} f64 {'+'.join(trainable)} "
                        f"gradients ({gc.numel()} entries), card vs CPU", gg,
                        gc, 1e-8,
                        "one sample, 64 landscape poses, before clipping")
                continue
            beyond = int((err > 1e-3 * scale).sum())
            median = float(err.median()) / scale
            ok = (bool(torch.isfinite(gg).all())
                  and beyond < 0.01 * gc.numel() and median < 1e-4)
            print(f"check grasp train {name} f32 {'+'.join(trainable)} "
                  f"gradients, card vs CPU: {beyond} of {gc.numel()} "
                  f"entries beyond 1e-3 x max|cpu| {scale:.6g} (limit 1%), "
                  f"max err "
                  f"{float(err.max()):.6g}, median err {median:.3g} x "
                  f"max|cpu| (limit 1e-4) {'OK' if ok else 'FAIL'} [{card}]")
            if not ok:
                raise AssertionError(f"grasp train {name} f32 gradients: card"
                                     " and CPU disagree")
        del base
        torch.cuda.empty_cache()


def run_grasp_trainer(dev, card, name, module, fn, fusion, cfg, cut,
                      tag="grasp train"):
    """One grasp trainer's run through its entry function on `cfg` (cut to
    `cut`) with its checks: each step's metrics and host time, the median
    step after the first, the peak memory, each validation's wall and
    logged errors, every frozen parameter bit-identical to the seeded one
    and the trainable ones moved, and the host time of one batch's
    synthesis. Returns the trainer's `GraspRun`, the launch counts of its
    run and that batch."""
    import importlib

    import numpy as np
    import torch
    from tcnerf_torch.train.grasp_common import build_grasp_model

    run = getattr(importlib.import_module(f"tcnerf_torch.train.{module}"), fn)
    gt, oc = cfg.grasp_training, cfg.validation.grasp_opt_config
    rep = cfg.grasp_model.get("rotation_representation", "quaternion")
    print(f"{tag} {name} ({module}): batch {gt.batch_size}, loss "
          f"{gt.loss}, {rep}"
          f", fusion {fusion}, full width, f32, seeded weights; "
          f"validation {len(cfg.validation.valid_sample_indices)} samples"
          f" x {oc.optimizer_config.n_initial_guesses} guesses x "
          f"{oc.optimization_config.n_optimization_steps} steps, "
          f"{oc.optimizer_config.n_images} images; cut: {cut}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    run_, wall = timed(lambda: run(cfg, device=dev))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    steps, valid = run_.history["steps"], run_.history["valid"]
    print(f"{tag} {name} run: {len(steps)} steps + {len(valid)} "
          f"validations in {wall:.1f} s (dataset synthesis included); "
          f"peak memory allocated {peak / 2 ** 30:.2f} GiB [{card}]")
    for k, s in enumerate(steps):
        metrics = ", ".join(f"{m} {v:.6f}" for m, v in s.items()
                            if m not in ("data_s", "step_s"))
        print(f"{tag} {name} step {k + 1}: {metrics}; "
              f"{s['step_s'] * 1e3:.1f} ms (waiting for the prefetched "
              f"batch {s['data_s'] * 1e3:.1f} ms) [{card}]")
        if not all(np.isfinite(v) for v in s.values()):
            raise AssertionError(f"{name}: step {k + 1} not finite")
    if len(steps) != 2:
        raise AssertionError(f"{name}: {len(steps)} steps, not 2")
    steady = float(np.median([s["step_s"] for s in steps[1:]]))
    print(f"{tag} {name} step after the first (median): "
          f"{steady * 1e3:.1f} ms [{card}]")
    for epoch, logged, seconds in valid:
        errors = ("warm-up, one sample" if logged is None else
                  f"mean_r_error_t {logged['mean_r_error_t']:.3f} mm, "
                  f"mean_r_error_r {logged['mean_r_error_r']:.3f} deg, "
                  f"best_r_error_mean_t "
                  f"{logged['best_r_error_mean_t']:.3f} mm, "
                  f"best_r_error_mean_r "
                  f"{logged['best_r_error_mean_r']:.3f} deg")
        print(f"{tag} {name} validation after epoch {epoch}: "
              f"{seconds * 1e3:.1f} ms wall; {errors} [{card}]")
        if logged is not None and not np.isfinite(
                logged["mean_r_error_t"]):
            raise AssertionError(f"{name}: validation errors not finite")
    state = run_.state
    seeded = build_grasp_model(cfg, fusion=fusion, device=dev)
    trained = set(state.names)
    frozen_same = moved = 0
    for (n, p), q in zip(state.model.named_parameters(),
                         seeded.parameters()):
        same = torch.equal(p.detach(), q.detach())
        if n in trained:
            moved += not same
        elif not same or p.grad is not None:
            raise AssertionError(f"{name}: frozen {n} changed")
        else:
            frozen_same += 1
    print(f"check {tag} {name} frozen parameters: {frozen_same} "
          f"tensors bit-identical to the seeded ones after {len(steps)} "
          f"steps, without gradients; {moved} of {len(trained)} "
          f"trainable tensors moved {'OK' if moved else 'FAIL'}")
    if not moved:
        raise AssertionError(f"{name}: the readout did not train")
    del seeded
    t0 = time.perf_counter()
    batch = run_.data_generator[0]
    print(f"{tag} {name}: one batch synthesized on the host "
          f"without the prefetch thread in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")
    return run_, counts, batch


def check_trained_probe(model, cfg, counts, name, dev, card):
    """A grasp trainer's run launches the probe kernels in its validation
    ascents where `probe_engages` (its steps never: their weights take
    gradients), and none elsewhere. After the run's in-place updates, the
    final energies of 256 seeded guesses in a seeded scene through the
    kernels equal the plain path's within 1e-4 of the largest |plain|: the
    kernels' packed weights followed the updates."""
    import torch
    from tcnerf_torch.ops.probe import PROBE
    from tcnerf_torch.train.grasp_common import build_pose_optimizer

    fwd, bwd = counts.get("probe_fwd", 0), counts.get("probe_bwd", 0)
    engages = probe_engages(model)
    ok = fwd > 0 and bwd > 0 if engages else fwd == bwd == 0
    print(f"check grasp train {name} probe kernel launches over the run: "
          f"P1 {fwd}, P2 {bwd} (want "
          f"{'some, in the validation ascents' if engages else 'none'}) "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grasp train {name}: probe launches "
                             f"{(fwd, bwd)}")
    if not engages:
        return
    opt = build_pose_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    feats = torch.randn((1, opt.n_images, H, W, model.n_features),
                        generator=gen, device=dev)
    scene = opt.prepare(grasp_scene(opt.n_images, seed=4), feats)
    state = opt.init_state(opt.generate_initial_guesses(4, 256))
    before = PROBE.counts["probe_fwd"]
    got = opt.compute_current_grasp_success(state, scene)
    if PROBE.counts["probe_fwd"] != before + 1:
        raise AssertionError(f"grasp train {name}: the trained model's "
                             "energies did not launch the probe kernel")
    with plain_probe(model):
        want = opt.compute_current_grasp_success(state, scene)
    compare(f"grasp train {name} final energies of 256 guesses after the "
            f"run's updates, probe kernels vs the plain path", got, want,
            1e-4, f"the trained weights, packed again after each update "
            f"[{card}]")
    del opt, scene, feats
    torch.cuda.empty_cache()


def phase_grasp_train(dev, card, launches, root):
    """The four grasp trainers through their entry functions
    (`tcnerf_torch.train.train_goal`, `train_delta_ngf`, `train_trajectory`,
    `train_language`) at full width (ViT-B/16 224^2, n_features 256,
    hidden 128, 6 blocks, 480x640, 7 5-d poses = 42 probes; the language
    config adds the CLIP RN50 and text towers and the v4-elu decoder),
    batch 8, seeded weights, on synthetic datasets (one per kind, shared by
    the trainers that read it), cut to GRASP_TRAIN_CUT (2 steps, a
    validation after each, and the warm-up) and for language_1_view to 5
    perspectives. Per trainer the checks of `run_grasp_trainer`, no
    chain-kernel launch (K1, K1', K2, K3 count 0) and those of
    `check_trained_probe` (the validations' probe kernels). A profiled
    step of goal_1_view and of language_1_view; then one step of each kind
    on the card against the CPU
    (`check_grasp_train_on_cpu`). The trainers' checkpoints go under
    `root`, with a backbone path where none is."""
    import torch
    from tcnerf_torch.train import config

    data_dir = REPO / "build" / "chip_smoke_grasp"
    totals = {k: 0 for k in CHAIN_COUNTS}
    for name, module, fn, fusion, kind in GRASP_TRAIN:
        model_path = root / "grasp_train" / name
        cut = GRASP_TRAIN_CUT + GRASP_TRAIN_EXTRA.get(name, [])
        cfg = config.load_config(
            [f"dataset.path={data_dir / kind}",
             f"grasp_training.model_path={model_path}",
             f"grasp_training.backbone_path={root / 'no_backbone'}", *cut],
            name)
        run_, counts, (inputs, labels) = run_grasp_trainer(
            dev, card, name, module, fn, fusion, cfg, cut)
        check_trained_probe(run_.state.model, cfg, counts, name, dev, card)
        for k, key in CHAIN_COUNTS.items():
            totals[k] += counts.get(key, 0)
        if name in ("goal_1_view", "language_1_view"):
            batch = (_moved(inputs, dev), _moved(labels, dev))
            print(f"grasp train {name} profiled step:")
            device_time_by_kernel(lambda: run_.step(*batch), card, top=8)
            del batch
        del run_
        torch.cuda.empty_cache()
    for k, n in totals.items():
        launches[f"{k} grasp_train"] = n
    print(f"grasp train launches of the chain kernels on the trainers' path: "
          f"{totals} (GraspEBM's embedding emits every activation, "
          f"complete_output, which no chain kernel does) "
          f"{'OK' if not any(totals.values()) else 'FAIL'}")
    if any(totals.values()):
        raise AssertionError("a chain kernel launched on the grasp trainers' "
                             "path")
    check_grasp_train_on_cpu(dev, card, data_dir)


def _capture_log():
    """Collect the trainers' log messages (`tcnerf_torch.train` at INFO);
    returns (messages, stop)."""
    import logging
    messages = []
    logger = logging.getLogger("tcnerf_torch.train")

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler, level = Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)

    def stop():
        logger.removeHandler(handler)
        logger.setLevel(level)
    return messages, stop


def _same_tensors(module, want, tag):
    """Every tensor of `module` equals `want[name]` (a state_dict on any
    device), bit for bit; raises otherwise."""
    import torch
    got = module.state_dict()
    bad = [k for k in got if not torch.equal(got[k], want[k].to(
        got[k].device))]
    if set(got) != set(want) or bad:
        raise AssertionError(f"{tag}: {len(bad)} tensors differ, e.g. "
                             f"{bad[:3]}; keys equal {set(got) == set(want)}")
    return len(got)


def _wrapped(module, name, check):
    """Replace module.name by a function that calls it, then
    `check(result, *args)`; returns the undo."""
    original = getattr(module, name)

    def wrapper(*args, **kw):
        out = original(*args, **kw)
        check(out, *args)
        return out
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, original)


def checkpoint_io(dev, card, model, path, components, fresh):
    """Per component of `model`: store seconds, bytes, load seconds of the
    file into `fresh` on the card (synchronized) and GB/s of the load;
    every tensor loaded bit for bit. Then both split into their parts:
    `to_flax` (the copy to the host and the layouts), `dumps`, the write;
    the read and parse, `from_flax`, the copies onto the card."""
    import os

    import torch
    from tcnerf_torch.models import checkpoint as ckpt
    from tcnerf_torch.models import msgpack_codec
    from tcnerf_torch.params import from_flax, to_flax

    for c in components:
        if not hasattr(model, c):
            continue
        file = ckpt.component_path(path, c)
        _, t_store = timed(lambda: ckpt.store(path, model, (c,)))
        size = os.path.getsize(file)
        _, t_load = timed(lambda: ckpt.load(path, fresh, (c,)))
        n = _same_tensors(getattr(fresh, c), getattr(model, c).state_dict(),
                          f"checkpoint file {c}")
        tree, t_to = timed(lambda: to_flax(getattr(model, c)))
        blob, t_dumps = timed(lambda: msgpack_codec.dumps(tree))

        def write():
            with open(file, "wb") as f:
                f.write(blob)
        _, t_write = timed(write)
        del tree, blob
        tree, t_read = timed(lambda: msgpack_codec.read(file))
        state, t_from = timed(lambda: from_flax(tree, dtype=None))
        target = getattr(fresh, c).state_dict(keep_vars=True)

        def copy():
            with torch.no_grad():
                for k, t in target.items():
                    t.copy_(state[k])
        _, t_copy = timed(copy)
        del tree, state
        print(f"checkpoint file {os.path.basename(path)}_{c}.msgpack: "
              f"{size} bytes ({n} tensors), store {t_store:.3f} s "
              f"({size / t_store / 1e9:.3f} GB/s: to_flax {t_to:.3f}, dumps "
              f"{t_dumps:.3f}, write {t_write:.3f}), load onto the card "
              f"{t_load:.3f} s ({size / t_load / 1e9:.3f} GB/s: read "
              f"{t_read:.3f}, from_flax {t_from:.3f}, copy_ {t_copy:.3f}), "
              f"bit for bit [{card}]")


def timed_stores(fn, name, card):
    """fn() with every `checkpoint.store` call timed; prints the phase's
    seconds and its stores' count and seconds, returns fn's result."""
    from tcnerf_torch.models import checkpoint as ckpt
    original, spent = ckpt.store, []

    def store(*args, **kw):
        t0 = time.perf_counter()
        original(*args, **kw)
        spent.append(time.perf_counter() - t0)
    ckpt.store = store
    try:
        out, wall = timed(fn)
    finally:
        ckpt.store = original
    print(f"{name}: {wall:.1f} s, of which {len(spent)} checkpoint stores "
          f"{sum(spent):.2f} s [{card}]")
    return out


def phase_checkpoint(dev, card, launches, root, scene, fused_final):
    """The three stages joined by checkpoint files under `root`, at full
    width. (1) `train_nerf._main` on nerf_1_view_wo (TRAIN_CUT, K1') for 2
    fit rounds of 1 epoch, then again with n_epochs 3: the rerun loads
    `model_final` (every tensor bit for bit the first run's final state,
    the K1' weight pack rebuilt after the in-place load), starts at epoch 2
    and skips the epoch-0 validation. (2) A renderer seeded otherwise
    loads `model_final`; its `render_view` (swg, K2) equals the trained
    model's bit for bit. (3) `train_goal` (goal_1_view, batch 8, one round)
    on that backbone: the backbone loads bit for bit; best_* and
    model_final_* hold the grasp components; a rerun with one round more
    resumes bit for bit. (4) `GraspPipeline.from_checkpoints` on a goal
    model seeded otherwise: 64 guesses' energies bit for bit the
    trainer's model's, and a steady 4096-guess infer. (5) `train_language`
    one round on phase_train_fused's v4-elu checkpoint: its decoder and
    backbone load bit for bit. (6) `store_tf` / `load_tf` of the goal
    model, bit for bit. (7) Per component file: bytes, store and load
    seconds, GB/s. The counts are set to 0 before the resumed stage-1 run
    and the served view and read after them."""
    import os

    import numpy as np
    import torch
    from tcnerf_torch.core import se3
    from tcnerf_torch.models import checkpoint as ckpt
    from tcnerf_torch.models.pipeline import GraspPipeline
    from tcnerf_torch.train import (config, grasp_common, train_delta_ngf,
                                    train_goal, train_language, train_nerf)

    # (1) stage 1: two rounds, then a resumed third
    data_dir = REPO / "build" / "chip_smoke_train"
    stage1 = root / "ckpt_stage1"
    cut = [f"data_dir={data_dir}", *TRAIN_CUT,
           f"nerf_training.model_path={stage1}",
           "nerf_training.eval_after_epochs=1"]
    cfg = config.load_config(cut + ["nerf_training.n_epochs=2"],
                             "nerf_1_view_wo")
    print(f"checkpoint stage 1: nerf_1_view_wo at full width, 2 rounds of 1 "
          f"epoch into {stage1}, then a rerun with n_epochs 3")
    (state, history), wall = timed(lambda: train_nerf._main(cfg, dev))
    print(f"checkpoint stage 1 first run: {len(history['steps'])} steps, "
          f"validations after epochs {[e for e, _ in history['valid']]}, "
          f"{wall:.1f} s; files "
          f"{sorted(os.listdir(stage1))} [{card}]")
    final = {k: v.detach().clone() for k, v in
             state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    seen = {}
    original = train_nerf.init_weights

    def packs(embeddings):
        """Each embedding's K1' weight pack (built again only when its
        key, the parameters' pointers and versions, changed); the build
        counts."""
        for e in embeddings:
            e._chain_packs([e._chain_flat(e.feature_blocks, torch.float32),
                            e._chain_flat(e.fusion_blocks, torch.float32)],
                           torch.float32)
        return [e.pack_builds for e in embeddings]

    def init_weights(model, cfg_):
        # the packs of the seeded weights first: the in-place load must
        # change their key
        embeddings = (model.coarse_embedding, model.fine_embedding)
        seen["before"] = packs(embeddings)
        original(model, cfg_)
        seen["after"] = packs(embeddings)
        seen["loaded"] = _same_tensors(model, final, "stage-1 resume")

    cfg3 = config.load_config(cut + ["nerf_training.n_epochs=3"],
                              "nerf_1_view_wo")
    messages, stop = _capture_log()
    train_nerf.init_weights = init_weights
    reset_counts()
    try:
        (state, history), wall = timed(lambda: train_nerf._main(cfg3, dev))
    finally:
        train_nerf.init_weights = original
        stop()
    counts = read_counts()
    launches["K1' checkpoint"] = counts.get("resmlp_rows_diff", 0)
    valid = [e for e, _ in history["valid"]]
    logged = [m for m in messages if m.startswith("Model loaded from")
              or m.startswith("Starting training from epoch")]
    print(f"checkpoint stage 1 resumed run: {logged}; {len(history['steps'])}"
          f" steps, validations after epochs {valid}, {wall:.1f} s; right "
          f"after the load {seen['loaded']} tensors bit-identical to the "
          f"first run's final state; K1' packs built {seen['before']} before"
          f" the load, {seen['after']} after it; launches {counts} [{card}]")
    if not (any(m.startswith("Model loaded from") for m in logged)
            and "Starting training from epoch 2" in logged and valid == [3]
            and len(history["steps"]) == 1):
        raise AssertionError("stage 1 did not resume at epoch 2")
    if seen["after"] != [b + 1 for b in seen["before"]]:
        raise AssertionError("the in-place load did not rebuild K1''s pack")
    if launches["K1' checkpoint"] == 0:
        raise AssertionError("the resumed stage-1 run launched no K1'")
    trained = state.model

    # (2) serve the file: a renderer seeded otherwise, loaded
    served = train_nerf.build_model(config.load_config(
        cut + ["nerf_training.n_epochs=3", "seed=7"], "nerf_1_view_wo"), dev)
    ok, t_load = timed(lambda: ckpt.load(
        str(stage1 / "model_final"), served,
        ckpt.RENDERER_WITHOUT_COMPONENTS))
    if not ok:
        raise AssertionError("model_final did not load")
    want = view_fn(trained, scene, dev)()
    reset_counts()
    got, t_view = timed(view_fn(served, scene, dev))
    counts = read_counts()
    launches["K2 checkpoint"] = counts.get("swg_head_inside", 0)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    print(f"check checkpoint served view: a renderer seeded otherwise, "
          f"model_final loaded in {t_load:.3f} s, render_view {H}x{W} "
          f"{t_view * 1e3:.1f} ms with {dict(counts)}; rgb and depth vs the "
          f"trained model's {'bit for bit OK' if same else 'FAIL'} [{card}]")
    if not same or launches["K2 checkpoint"] != 76:
        raise AssertionError("the served view differs from the trained "
                             "model's, or did not launch K2 76 times")
    checkpoint_io(dev, card, trained, str(root / "io" / "stage1"),
                  ckpt.RENDERER_WITHOUT_COMPONENTS, served)
    del served, state
    torch.cuda.empty_cache()

    # (3) stage 2 on that backbone, then resumed
    grasp_dir = REPO / "build" / "chip_smoke_grasp"
    goal_dir = root / "ckpt_goal"
    goal_cut = [f"dataset.path={grasp_dir / 'goal'}",
                f"grasp_training.model_path={goal_dir}",
                f"grasp_training.backbone_path={stage1}",
                "grasp_training.eval_after_epochs=1"]

    def backbone_loaded(out, model, *_):
        seen["backbone"] = out[1]
        seen["backbone_same"] = sum(
            _same_tensors(getattr(model, c), getattr(trained, c).state_dict(),
                          f"backbone {c}")
            for c in ckpt.BACKBONE_COMPONENTS)

    undo = _wrapped(train_goal, "load_backbone", backbone_loaded)
    try:
        run, wall = timed(lambda: train_goal.run_goal_training(
            config.load_config(goal_cut + ["grasp_training.n_epochs=1"],
                               "goal_1_view"), device=dev))
    finally:
        undo()
    files = sorted(f for f in os.listdir(goal_dir) if f.endswith(".msgpack"))
    want_files = sorted(f"{k}_{c}.msgpack" for k in ("best", "model_final")
                        for c in ("fine_embedding", "visual_features",
                                  "grasp_readout"))
    print(f"checkpoint goal_1_view on the stage-1 backbone: load_backbone "
          f"{seen['backbone']}, {seen['backbone_same']} backbone tensors "
          f"bit-identical to stage 1's before the first step; "
          f"{len(run.history['steps'])} step, {wall:.1f} s; files {files} "
          f"[{card}]")
    if not seen["backbone"] or files != want_files:
        raise AssertionError("the goal stage did not load its backbone, or "
                             "stored other files")
    goal_final = {k: v.detach().clone() for k, v in
                  run.state.model.state_dict().items()}
    del run
    torch.cuda.empty_cache()

    def resumed(out, model, *_):
        seen["resumed"] = _same_tensors(model, goal_final, "goal resume")

    undo = _wrapped(train_goal, "resume_or_init", resumed)
    messages, stop = _capture_log()
    try:
        run, wall = timed(lambda: train_goal.run_goal_training(
            config.load_config(goal_cut + ["grasp_training.n_epochs=2"],
                               "goal_1_view"), device=dev))
    finally:
        undo()
        stop()
    epochs = [e for e, _, _ in run.history["valid"]]
    print(f"checkpoint goal_1_view rerun: "
          f"{[m for m in messages if m.startswith('Model loaded')]}, "
          f"{seen['resumed']} tensors bit-identical to the first run's; "
          f"{len(run.history['steps'])} step, validations {epochs}, "
          f"{wall:.1f} s [{card}]")
    if epochs != [None, 2] or len(run.history["steps"]) != 1:
        raise AssertionError("the goal stage did not resume at epoch 1")

    # (4) serve grasps from the files
    gcfg = config.load_config(goal_cut, "goal_1_view")
    fresh = grasp_common.build_grasp_model(
        config.load_config(goal_cut + ["seed=7"], "goal_1_view"), device=dev)
    pipe, t_build = timed(lambda: GraspPipeline.from_checkpoints(
        fresh, str(goal_dir), gcfg.generator_grasp.workspace_bounds,
        backbone_dir=str(stage1), n_initial_guesses=4096, n_images=3,
        n_optimization_steps=16, clip_translation=True))
    memory = run.state.model.eval()
    n = _same_tensors(fresh, memory.state_dict(), "pipeline weights")
    images, intr, ext = (torch.as_tensor(x, device=dev)
                         for x in grasp_scene(3, seed=2))
    rng = np.random.default_rng(4)
    bounds = np.asarray(gcfg.generator_grasp.workspace_bounds, np.float32)
    poses = se3.pose_to_matrix(
        torch.as_tensor(rng.uniform(bounds[:, 0], bounds[:, 1], (1, 64, 3)),
                        dtype=torch.float32, device=dev),
        torch.as_tensor(rng.normal(size=(1, 64, 4)), dtype=torch.float32,
                        device=dev)).expand(3, -1, -1, -1)

    def fold(x):
        return x.reshape((3, 1) + tuple(x.shape[2:]))

    with torch.no_grad():
        energies = [m.energy(poses, fold(images), fold(intr), fold(ext),
                             fold(m.compute_features(images)))
                    for m in (fresh, memory)]
    same = torch.equal(*energies)
    scene3 = grasp_scene(3, seed=2)
    pipe.infer(*scene3, rng=0)
    walls = []
    for _ in range(3):
        result, t = timed(lambda: pipe.infer(*scene3, rng=0))
        walls.append(t * 1e3)
    print(f"check checkpoint pipeline: from_checkpoints in {t_build:.3f} s, "
          f"{n} tensors as the trainer's model; 64 guesses' energies vs the "
          f"trainer's in-memory model {'bit for bit OK' if same else 'FAIL'};"
          f" infer (4096 guesses, 16 steps, 3 images) steady "
          f"{float(np.median(walls)):.1f} ms (median of "
          f"{[round(w, 1) for w in walls]}; phase_grasp's seeded model, "
          f"above), top scores "
          f"{[round(x, 4) for x in result.scores]} [{card}]")
    if not same or not np.isfinite(result.all_energies).all():
        raise AssertionError("the pipeline from files differs from the "
                             "trainer's model")
    checkpoint_io(dev, card, memory, str(root / "io" / "goal"),
                  ckpt.GRASP_COMPONENTS, fresh)

    # (6) the TF bundle layout
    tf_fresh = grasp_common.build_grasp_model(
        config.load_config(goal_cut + ["seed=8"], "goal_1_view"), device=dev)
    _, t_store = timed(lambda: ckpt.store_tf(str(root / "tf" / "goal"),
                                             memory, ckpt.GRASP_COMPONENTS))
    _, t_load = timed(lambda: ckpt.load_tf(str(root / "tf" / "goal"),
                                           tf_fresh, ckpt.GRASP_COMPONENTS))
    n = _same_tensors(tf_fresh, memory.state_dict(), "TF bundle")
    print(f"check checkpoint TF bundle: store_tf {t_store:.3f} s, load_tf "
          f"{t_load:.3f} s, {n} tensors bit for bit OK [{card}]")
    del run, pipe, fresh, tf_fresh, memory, energies, goal_final, final
    torch.cuda.empty_cache()

    # (5) the language stage on the v4-elu stage-1 checkpoint
    def decoder_loaded(out, model, *_):
        seen["language"] = out[1]
        seen["language_same"] = sum(
            _same_tensors(getattr(model, c), fused_final[c],
                          f"language backbone {c}") for c in fused_final)

    undo = _wrapped(train_delta_ngf, "load_backbone", decoder_loaded)
    try:
        run, wall = timed(lambda: train_language.run_language_training(
            config.load_config(
                [f"dataset.path={grasp_dir / 'language'}",
                 "dataset.n_perspectives=5",
                 f"grasp_training.model_path={root / 'ckpt_language'}",
                 f"grasp_training.backbone_path="
                 f"{root / 'nerf_1_view_v4_elu'}",
                 "grasp_training.n_epochs=1",
                 "grasp_training.eval_after_epochs=1"], "language_1_view"),
            device=dev))
    finally:
        undo()
    print(f"check checkpoint language_1_view on the nerf_1_view_v4_elu "
          f"checkpoint: load_backbone {seen['language']}, "
          f"{seen['language_same']} tensors of fine_embedding, "
          f"visual_features and combine_clip_visual bit-identical to stage "
          f"1's; {len(run.history['steps'])} step, {wall:.1f} s [{card}]")
    if not seen["language"]:
        raise AssertionError("the language stage did not load its backbone")
    del run
    torch.cuda.empty_cache()
    k1d = launches["K1' checkpoint"]
    print(f"checkpoint launches: K1' {k1d} in the resumed stage-1 run, K2 "
          f"{launches['K2 checkpoint']} in the view served from the file "
          f"[{card}]")


# nerf_convergence_hashgrid cut to one fit round of 8 one-scene steps
HASHGRID_CUT = ["nerf_training.n_epochs=8",
                "nerf_training.eval_after_epochs=8"]


def draw_log(rng, pool):
    """A numpy Generator on `rng`'s bit generator (the same stream) that
    records in `.drawn` the perspectives drawn from `pool` (its `choice`
    of that array)."""
    import numpy as np

    class DrawLog(np.random.Generator):
        def choice(self, a, *args, **kw):
            out = super().choice(a, *args, **kw)
            if a is pool:
                self.drawn.extend(int(v) for v in out)
            return out

    log = DrawLog(rng.bit_generator)
    log.drawn = []
    return log


def check_grads_on_cpu(tag, model, loss_fn, tol=1e-3):
    """loss_fn(model, device) on the card and on a CPU copy of `model`: the
    loss within `tol` relative, each parameter's gradient within `tol` x
    its max |cpu|."""
    import copy

    import torch
    out = []
    for m, d in ((model, next(model.parameters()).device),
                 (copy.deepcopy(model).cpu(), torch.device("cpu"))):
        m.zero_grad(set_to_none=True)
        loss = loss_fn(m, d)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.detach().cpu()
                                  for n, p in m.named_parameters()}))
        m.zero_grad(set_to_none=True)
    (lg, gg), (lc, gc) = out
    rel = abs(lg - lc) / abs(lc)
    worst = max((float((gg[n] - gc[n]).abs().max())
                 / max(float(gc[n].abs().max()), 1e-30), n) for n in gc)
    ok = rel <= tol and worst[0] <= tol
    print(f"check {tag}, card vs CPU: loss {lg:.8g} / {lc:.8g} (err "
          f"{rel:.3g} relative), gradients of {len(gc)} tensors: largest "
          f"error {worst[0]:.3g} x the tensor's max|cpu| ({worst[1]}); limit"
          f" {tol} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: card and CPU disagree")


def phase_hashgrid(dev, card, launches, root):
    """The hash-grid field at the JAX configs' width (16 levels of 2^14 x 2
    f32 tables, base 16, finest 512; a 3-layer, 64-wide relu MLP on the 32
    + 3 inputs), with the counts set to 0 before and read after:

    * stage-1: `train_nerf._main` on `nerf_convergence_hashgrid` (one
      synthetic scene of 16 480x640 perspectives, 4096 rays of 64 + 64
      samples, near 0.55, far 1.8, the trainer's 32 chunks of 128 rays,
      lr 1e-2), cut to HASHGRID_CUT (8 steps); the held-out target view
      never drawn, the tables moved, finite losses, `model_final` resumed
      bit for bit, one step card vs CPU (1e-3), a profiled step;
    * serving: `render_view` 480x640 of the held-out view on the plain
      path at chunk 512 (the default) and 8192, one 8192-ray chunk card vs
      CPU (f32, 1e-3), a profiled render at each chunk (the whole view at
      8192, its top 16 rows at 512);
    * grasp training: `train_delta_ngf` on `dngf_hashgrid` (batch 8, the
      tables and the readout training; GRASP_TRAIN_CUT: 2 steps), the
      backbone bit-identical, one step card vs CPU
      (`check_grasp_train_on_cpu`);
    * grasp serving: `GraspPipeline.from_checkpoints` on that run's files,
      `infer` with 4096 guesses and the config's validation schedule
      (`phase_grasp`, its checks).

    No chain kernel lies on this path (JAX's hash-grid renderer skips the
    corner image and the chain): K1, K1', K2 and K3 must count 0."""
    import numpy as np
    import torch
    from tcnerf_torch.data.generators import to_device
    from tcnerf_torch.data.loaders import load_dataset_nerf
    from tcnerf_torch.models import inference, training as T
    from tcnerf_torch.train import config, train_delta_ngf, train_nerf
    from tcnerf_torch.train.grasp_common import build_grasp_model

    reset_counts()
    t_phase = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"hashgrid part {what}: {now - t_phase[0]:.1f} s [{card}]")
        t_phase[0] = now

    data = REPO / "build" / "chip_smoke_hashgrid"
    cfg = config.load_config([f"data_dir={root / 'hashgrid'}",
                              f"dataset.path={data}", *HASHGRID_CUT],
                             "nerf_convergence_hashgrid")
    nm, nt = cfg.nerf_model, cfg.nerf_training
    held_out = cfg.valid_perspective_tgt_idx
    print(f"hashgrid stage 1: nerf_convergence_hashgrid at full width "
          f"({nm.hashgrid_levels} levels x 2^{nm.hashgrid_table_log2} x 2, "
          f"MLP {nm.hashgrid_layers} x {nm.hashgrid_hidden}, "
          f"{nm.n_rays_train} rays x {nm.n_samples} + {nm.n_samples} "
          f"samples, 480x640, lr {nt.learning_rate}), f32, seeded weights; "
          f"1 scene x {cfg.dataset.n_perspectives} perspectives, view "
          f"{held_out} held out; cut: {HASHGRID_CUT}")
    logs = []

    class Logged(train_nerf.MVNeRFDataGenerator):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.rng = draw_log(self.rng, self.perspective_pool)
            logs.append(self.rng)

    original = train_nerf.MVNeRFDataGenerator
    train_nerf.MVNeRFDataGenerator = Logged
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        (state, history), wall = timed(lambda: train_nerf._main(cfg, dev))
    finally:
        train_nerf.MVNeRFDataGenerator = original
    peak = torch.cuda.max_memory_allocated(dev)
    steps, model = history["steps"], state.model
    print(f"hashgrid stage 1 run: {len(steps)} steps + "
          f"{len(history['valid'])} validation renders in {wall:.1f} s "
          f"(dataset synthesis included); peak memory allocated "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")
    for st in steps:
        print(f"hashgrid train step {st['step']}: loss {st['loss']:.6f}, "
              f"{st['step_s'] * 1e3:.1f} ms (waiting for the prefetched "
              f"batch {st['data_s'] * 1e3:.1f} ms) [{card}]")
    if len(steps) != 8 or not all(np.isfinite(st["loss"]) for st in steps):
        raise AssertionError("hashgrid stage 1: not 8 finite steps")
    steady = float(np.median([st["step_s"] for st in steps[1:]]))
    rays = nm.n_rays_train * nt.batch_size
    print(f"hashgrid train step after the first (median): "
          f"{steady * 1e3:.1f} ms, {rays / steady:.0f} rays/s [{card}]")
    for epoch, value in history["valid"]:
        print(f"hashgrid validation (held-out view {held_out}) after epoch "
              f"{epoch}: PSNR {value:.3f} dB")
    drawn = sorted(set(logs[0].drawn))
    ok = bool(drawn) and held_out not in drawn
    print(f"check hashgrid held-out view: the generator drew perspectives "
          f"{drawn} ({len(logs[0].drawn)} draws), never {held_out} "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("hashgrid: the held-out view was drawn")
    seeded = train_nerf.build_model(cfg, dev)
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), seeded.state_dict()[n])]
    print(f"check hashgrid trained tensors: {len(moved)} of "
          f"{len(seeded.state_dict())} moved, the tables among them "
          f"{'OK' if 'fine_embedding.hash_tables' in moved else 'FAIL'}")
    if "fine_embedding.hash_tables" not in moved:
        raise AssertionError("hashgrid: the tables did not train")
    train_nerf.init_weights(seeded, cfg)       # model_final, in place
    n = _same_tensors(seeded, model.state_dict(), "hashgrid resume")
    print(f"check hashgrid model_final: {n} tensors "
          f"({sorted(os.listdir(nt.model_path))}) loaded bit for bit OK")
    del seeded
    lap("stage-1 run and its checks")

    ds = load_dataset_nerf(cfg.dataset.n_perspectives, f"{data}/train")
    gen = train_nerf.MVNeRFDataGenerator(
        ds, n_rays_train=nm.n_rays_train, batch_size=1, n_views=1, rng=5,
        exclude_perspectives=(held_out,))
    batch = to_device(*gen[0], dev)
    draws = T.draw_samples(model, 1, nm.n_rays_train,
                           torch.Generator(device=dev).manual_seed(7), dev)
    check_grads_on_cpu(
        f"hashgrid train step ({nm.n_rays_train} rays in chunks of 128)",
        model, lambda m, d: T.nerf_loss(
            m, tuple(x.to(d) for x in batch[0]), batch[1].to(d),
            *(u.to(d) for u in draws)))
    print("hashgrid profiled train step:")
    device_time_by_kernel(
        lambda: T.nerf_train_step(state, *batch,
                                  torch.Generator(device=dev).manual_seed(8)),
        card, top=10)
    lap("stage-1 step card vs CPU, profiled step")

    valid = train_nerf.load_validation(cfg, ds)
    scene = (valid["src_colors"][0], valid["src_camera_configs"][0],
             valid["tgt_camera_config"])
    model.eval()
    src_t, k4, ext, pose, k3 = scene_tensors(scene, dev)
    empty = torch.zeros((1, 1, 1, 1, 0), device=dev)
    # chunk 512 (the default) once: nothing compiles, and the stage-1
    # validations rendered it twice already; chunk 8192 after a first call
    for chunk, calls in ((512, 1), (8192, 2)):
        view = view_fn(model, scene, dev, chunk=chunk)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(calls):
            (rgb, depth), t = timed(view)
        peak = torch.cuda.max_memory_allocated(dev)
        if rgb.shape != (H, W, 3) or depth.shape != (H, W, 1):
            raise AssertionError(f"hashgrid view shapes {rgb.shape}")
        value = float(np.mean((rgb / 255.0 - valid["tgt_colors"][..., :3]
                               / 255.0) ** 2))
        print(f"hashgrid serve (plain path, chunk {chunk}): view "
              f"{t * 1e3:.1f} ms, {H * W / t:.0f} rays/s, peak memory "
              f"allocated {peak / 2 ** 30:.2f} GiB, PSNR against the "
              f"held-out view {-10 * np.log10(max(value, 1e-12)):.3f} dB "
              f"[{card}]")
        # the profiler's own cost grows with the launches: at chunk 512 a
        # strip of the view's top 16 rows (20 chunks), the same loop
        rows = H if chunk == 8192 else 16
        print(f"hashgrid profiled render at chunk {chunk}, the top {rows} "
              f"rows of the view:")
        with torch.inference_mode():
            device_time_by_kernel(lambda: inference.render_all_rays(
                model, src_t, k4, ext, empty, pose, k3, rows, W, chunk,
                generator=torch.Generator(device=dev).manual_seed(1)),
                card, top=6)
        lap(f"serving at chunk {chunk}")
    ro, rd, u_c, u_f = middle_chunk(pose, k3, dev)
    outs = []
    for m, d in ((model, dev), (copy.deepcopy(model).cpu(),
                                torch.device("cpu"))):
        with torch.no_grad():
            outs.append([x.cpu() for x in m.render_rays(
                ro.to(d), rd.to(d), src_t.to(d), k4.to(d), ext.to(d),
                empty.to(d), u_coarse=u_c.to(d), u_fine=u_f.to(d))])
    for label, got, want in zip(("rgb", "depth", "fine_rgb", "fine_depth"),
                                *outs):
        compare(f"hashgrid serve chunk {label} ({CHUNK} rays), card vs CPU",
                got, want, 1e-3, "f32, the same draws")
    del model, state, outs
    torch.cuda.empty_cache()
    lap("serving chunk card vs CPU")

    gcfg = config.load_config(
        [f"dataset.path={REPO / 'build' / 'chip_smoke_grasp' / 'grad'}",
         f"grasp_training.model_path={root / 'hashgrid_grasp'}",
         f"grasp_training.backbone_path={root / 'no_backbone'}",
         *GRASP_TRAIN_CUT], "dngf_hashgrid")
    gm = gcfg.grasp_model
    print(f"hashgrid grasp train: dngf_hashgrid (hash stream {gm.hash_levels}"
          f" x 2^{gm.hash_size_log2} x {gm.hash_features} over the "
          f"workspace, tables trained with the readout), batch "
          f"{gcfg.grasp_training.batch_size}, full width, f32, seeded "
          f"weights; cut: {GRASP_TRAIN_CUT}")
    torch.cuda.reset_peak_memory_stats(dev)
    run_, wall = timed(lambda: train_delta_ngf.run_delta_training(
        gcfg, device=dev))
    peak = torch.cuda.max_memory_allocated(dev)
    gsteps = run_.history["steps"]
    for k, st in enumerate(gsteps):
        metrics = ", ".join(f"{m} {v:.6f}" for m, v in st.items()
                            if m not in ("data_s", "step_s"))
        print(f"hashgrid grasp train step {k + 1}: {metrics}; "
              f"{st['step_s'] * 1e3:.1f} ms (waiting for the prefetched "
              f"batch {st['data_s'] * 1e3:.1f} ms) [{card}]")
    if len(gsteps) != 2 or not all(np.isfinite(v) for st in gsteps
                                   for v in st.values()):
        raise AssertionError("hashgrid grasp train: not 2 finite steps")
    print(f"hashgrid grasp train run: {wall:.1f} s with "
          f"{len(run_.history['valid'])} validations; peak memory allocated"
          f" {peak / 2 ** 30:.2f} GiB [{card}]")
    seeded = build_grasp_model(gcfg, device=dev)
    trained = run_.state.model.state_dict()
    frozen = [k for k in trained if k.split(".", 1)[0] not in
              ("grasp_readout", "hash_tables")]
    same = sum(torch.equal(trained[k], seeded.state_dict()[k])
               for k in frozen)
    tables = not torch.equal(trained["hash_tables"], seeded.hash_tables)
    ok = same == len(frozen) and tables and "hash_tables" in run_.state.names
    print(f"check hashgrid grasp train: {same} of {len(frozen)} backbone "
          f"tensors bit-identical to the seeded ones; the tables moved "
          f"{tables} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("hashgrid grasp train: frozen tensors moved or "
                             "the tables did not")
    trained = {k: v.clone() for k, v in trained.items()}
    del run_, seeded
    torch.cuda.empty_cache()
    lap("grasp training")
    # the f32 cosine losses read the pose gradient, which is ill-conditioned
    # in f32 (ROADMAP Queue C): held on the card's relu branches; the CPU's
    # own f32 run is printed beside its f64 distance
    check_grasp_train_on_cpu(dev, card, REPO / "build" / "chip_smoke_grasp",
                             names=("dngf_hashgrid",),
                             trainable=("grasp_readout", "hash_tables"),
                             own_tol=None)
    lap("grasp train step card vs CPU")
    phase_grasp(dev, card, "dngf_hashgrid", model_dir=root / "hashgrid_grasp",
                trained=trained)
    lap("grasp serving")
    counts = read_counts()
    for k, key in CHAIN_COUNTS.items():
        launches[f"{k} hashgrid"] = counts.get(key, 0)
    got = {k: counts.get(key, 0) for k, key in CHAIN_COUNTS.items()}
    print(f"hashgrid launches of the chain kernels on the path: {got} (the "
          f"hash-grid field reads no image: no corner image, no chain) "
          f"{'OK' if not any(got.values()) else 'FAIL'}")
    if any(got.values()):
        raise AssertionError("a chain kernel launched on the hash-grid path")


# the grasp trainers that read a collected dataset (goal_1_view and
# dngf_1_view), one train batch of samples
COLLECT_TRAIN = GRASP_TRAIN[:2]
COLLECT_SAMPLES = 8


def check_collected(root, split, n, n_perspectives):
    """The file-level invariants of each collected sample under
    `root/split`: it loads through `load_dataset_baseline`,
    `load_dataset(record_order=True)` and `load_dataset_language`; its
    images are `n_perspectives` of H x W; `grasp_pose` is a rigid 4x4 the
    same in both loaders, on top of its target sphere, ending the
    trajectory whose length `order` records; exactly one object of `info`
    is the target and the language string names its colour."""
    import numpy as np
    from tcnerf_torch.data.loaders import (load_dataset,
                                           load_dataset_baseline,
                                           load_dataset_language)
    from tcnerf_torch.data.synthetic import color_name

    base = load_dataset_baseline(str(root), n_perspectives, split)
    grad = load_dataset(str(root), n_perspectives, record_grasp_pose=True,
                        record_order=True, dataset_type=split)
    lang = load_dataset_language(n_perspectives, str(root / split))
    if not len(base) == len(grad) == len(lang) == n:
        raise AssertionError(f"collect {split}: {len(base)} / {len(grad)} "
                             f"/ {len(lang)} samples, not {n}")
    for i in range(n):
        colors = base.datasets["color"].read_sample(i)
        if colors.shape[:3] != (n_perspectives, H, W):
            raise AssertionError(f"collect {split} {i}: images {colors.shape}")
        g = np.asarray(base.datasets["grasp_pose"].read_sample(i))
        rot = g[:3, :3]
        rigid = (g.shape == (4, 4) and np.allclose(rot.T @ rot, np.eye(3),
                                                   atol=1e-12)
                 and abs(np.linalg.det(rot) - 1) < 1e-12
                 and np.array_equal(g[3], [0, 0, 0, 1]))
        info = base.datasets["info"].read_sample(i)
        targets = [k for k, v in info.items() if v["is_target"]]
        traj = grad.datasets["trajectory"].read_sample(i)
        text = lang.datasets["language"].read_sample(i)
        ok = (rigid and len(targets) == 1
              and np.array_equal(g, grad.datasets["grasp_pose"].read_sample(i))
              and int(grad.datasets["order"].read_sample(i)) == len(traj)
              and np.array_equal(traj[-1], g))
        if ok:
            t = info[targets[0]]
            top = np.asarray(t["position"]) + [0, 0, t["radius"]]
            ok = (np.abs(g[:3, 3] - top).max() < 1e-9 and text ==
                  f"grasp the {color_name(t['color'])} ball")
        if not ok:
            raise AssertionError(f"collect {split} sample {i}: {text!r}, "
                                 f"targets {targets}, rigid {rigid}")
    print(f"check collect {split}: {n} samples load through the three "
          f"loaders; grasp poses rigid on top of their one target; the "
          f"language names the target's colour OK")


def validate_with_plugin_oracle(card, cfg, model):
    """`session.validate` of the trained goal model on the collected
    validation samples, once with `build_oracle(cfg)` (the suction oracle,
    scored through the `OracleAgent` fallback) and once with
    `OracleAgent()`: the same poses, energies and errors. Returns the
    launch counts of both."""
    import numpy as np
    from tcnerf_torch.data.loaders import load_dataset_baseline
    from tcnerf_torch.tasks.agents import OracleAgent
    from tcnerf_torch.train import session
    from tcnerf_torch.train.grasp_common import (build_oracle,
                                                 build_pose_optimizer,
                                                 collect_valid_data)

    oracle = build_oracle(cfg)
    if hasattr(oracle, "calculate_error"):
        raise AssertionError(f"{type(oracle).__name__} scores itself")
    valid = load_dataset_baseline(cfg.dataset.path, cfg.dataset.n_perspectives,
                                  "valid")
    opt = build_pose_optimizer(model, cfg)
    valid_data = collect_valid_data(valid, cfg, model)
    oc = cfg.validation.grasp_opt_config.optimization_config.to_dict()
    reset_counts()
    results = {}
    for tag, o in (("plugin", oracle), ("agent", OracleAgent())):
        results[tag], wall = timed(lambda: session.validate(
            opt, oc, valid_data, oracle=o, rng=cfg.get("seed", 0)))
        errors = [r["errors_r"][-1] for r in results[tag]]
        print(f"collect validate with {type(o).__name__}: "
              f"{len(valid_data)} samples in {wall * 1e3:.1f} ms; best "
              "errors " + ", ".join(f"{t * 1000:.3f} mm / "
                                    f"{r / np.pi * 180:.3f} deg"
                                    for t, r in errors) + f" [{card}]")
    same = all(
        a["errors_r"] == b["errors_r"]
        and a["final_success"] == b["final_success"]
        and all(np.array_equal(x.matrix, y.matrix)
                for x, y in zip(a["grasp_poses"], b["grasp_poses"]))
        for a, b in zip(results["plugin"], results["agent"]))
    print(f"check collect validate: build_oracle(cfg) is "
          f"{type(oracle).__name__}, its poses, energies and errors equal "
          f"OracleAgent's {'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the plugin oracle's validation differs from "
                             "OracleAgent's")
    return read_counts()


def phase_collect(dev, card, launches, root):
    """The task layer's data collection feeding the grasp trainers: a
    goal_1_view-shaped dataset collected through
    `tcnerf_torch.data.collect.collect_grasp_dataset` (the grasp task from
    the plugin factory, the virtual scene's ray-traced cameras, the
    suction oracle; H x W, 5 perspectives, 3 objects, the trajectory's
    order recorded) into `root/collect`: COLLECT_SAMPLES train samples (one
    batch of 8) and as many validation samples as
    `validation.valid_sample_indices` reach, with their host seconds and
    file-level invariants (`check_collected`). Then `goal_1_view` and
    `dngf_1_view` trained on it through `train_goal` / `train_delta_ngf`
    (`run_grasp_trainer`: full width, batch 8, seeded weights,
    GRASP_TRAIN_CUT; the dataset path holds the collection, so nothing is
    synthesized), the trained goal model validated with the plugin oracle
    against `OracleAgent` (`validate_with_plugin_oracle`), and no chain
    kernel launched in the phase (K1, K1', K2, K3 count 0)."""
    import torch
    from tcnerf_torch.data.collect import collect_grasp_dataset
    from tcnerf_torch.train import config

    data = root / "collect"
    totals = {k: 0 for k in CHAIN_COUNTS}
    reset_counts()
    goal = config.load_config([], "goal_1_view")
    n_persp = goal.dataset.n_perspectives
    n_valid = max(goal.validation.valid_sample_indices) + 1
    for split, n, seed in (("train", COLLECT_SAMPLES, 0),
                           ("valid", n_valid, 1)):
        _, wall = timed(lambda: collect_grasp_dataset(
            str(data / split), n, n_perspectives=n_persp, n_objects=3,
            image_size=(H, W), rng=seed, record_order=True))
        print(f"collect {split}: {n} samples x {n_persp} perspectives at "
              f"{H}x{W}, 3 objects, in {wall:.2f} s on the host, "
              f"{wall / n:.3f} s a sample [{card}]")
        check_collected(data, split, n, n_persp)
    counts = read_counts()
    for k, key in CHAIN_COUNTS.items():
        totals[k] += counts.get(key, 0)
    for name, module, fn, fusion, _ in COLLECT_TRAIN:
        cfg = config.load_config(
            [f"dataset.path={data}",
             f"grasp_training.model_path={root / 'collect_train' / name}",
             f"grasp_training.backbone_path={root / 'no_backbone'}",
             *GRASP_TRAIN_CUT], name)
        run_, counts, _ = run_grasp_trainer(dev, card, name, module, fn,
                                            fusion, cfg, GRASP_TRAIN_CUT,
                                            tag="collect train")
        if name == "goal_1_view":
            more = validate_with_plugin_oracle(card, cfg, run_.state.model)
            counts = {k: counts.get(k, 0) + more.get(k, 0)
                      for k in set(counts) | set(more)}
        for k, key in CHAIN_COUNTS.items():
            totals[k] += counts.get(key, 0)
        del run_
        torch.cuda.empty_cache()
    for k, n in totals.items():
        launches[f"{k} collect"] = n
    print(f"collect launches of the chain kernels on the phase's path: "
          f"{totals} (the task layer is numpy on the host; the grasp "
          f"trainers' embedding emits every activation) "
          f"{'OK' if not any(totals.values()) else 'FAIL'}")
    if any(totals.values()):
        raise AssertionError("a chain kernel launched on the collection "
                             "phase's path")


# phase_convergence: the JAX package's records (docs/*.jsonl) less 1.5 dB
# for the other initial weights and arithmetic, at the epochs the cut run
# validates; fixed before the first run on the card
CONVERGENCE = "nerf_convergence_hashgrid_cpu"
CONVERGENCE_CUT = ["nerf_training.n_epochs=256"]
CONVERGENCE_BARS = {128: 21.02, 256: 22.84}
FULL_CONVERGENCE_CUT = ["nerf_training.n_epochs=2",
                        "nerf_training.eval_after_epochs=2",
                        "dataset.n_synthetic_samples=8"]
TRACE_CUT = ["nerf_training.n_epochs=2", "nerf_training.eval_after_epochs=2"]


def phase_convergence(dev, card, launches, root):
    """Trained quality and the convergence configs on the card:

    (a) `nerf_convergence_hashgrid_cpu` fit from the port's seeded weights
        through `tools/convergence.py` `fit` (`train_nerf`), cut to
        CONVERGENCE_CUT (validations at 0, 64, 128, 192, 256), its PSNR
        printed beside the JAX package's record and held at
        CONVERGENCE_BARS; the median step, its wait for the batch and one
        profiled step (device idle share); no chain kernel launches;
    (b) `nerf_convergence` at full width for one fit round
        (FULL_CONVERGENCE_CUT: 8 scenes, two steps of batch 8, the
        validations before and after them on the swg path): finite losses
        and PSNRs; the first step's learning rate is 0 (the warm-up), so
        after the second each trained group (nerf, feature) holds a
        tensor moved from the seeded weights and no frozen tensor moved;
        the K2 launches counted as `launches_convergence`;
    (c) a TCNERF_TRACE run (one fit round of 2 epochs of (a)'s config):
        one Chrome trace file holding CUDA kernel events."""
    import numpy as np
    import torch
    from tcnerf_torch.data.generators import to_device
    from tcnerf_torch.data.loaders import load_dataset_nerf
    from tcnerf_torch.models import training as T
    from tcnerf_torch.tools import convergence
    from tcnerf_torch.train import config, train_nerf

    data_dir = f"data_dir={root / 'convergence'}"
    reset_counts()
    print(f"convergence (a): {CONVERGENCE} from seeded weights, cut: "
          f"{CONVERGENCE_CUT}; bars {CONVERGENCE_BARS} dB (the JAX "
          f"record less 1.5 dB)")
    cfg, state, history = convergence.fit(CONVERGENCE,
                                          [data_dir, *CONVERGENCE_CUT])
    counts = read_counts()
    chain = {k: counts.get(key, 0) for k, key in CHAIN_COUNTS.items()}
    nm, nt = cfg.nerf_model, cfg.nerf_training
    steps = history["steps"]
    n_steps = nt.n_epochs * cfg.dataset.n_synthetic_samples // nt.batch_size
    if (len(steps) != n_steps
            or not all(np.isfinite(st["loss"]) for st in steps)):
        raise AssertionError(f"convergence (a): not {n_steps} finite steps")
    rows = convergence.compare(
        convergence.read_metrics(nt.model_path),
        convergence.read_metrics(convergence.record_path(CONVERGENCE)),
        CONVERGENCE_BARS)
    print(convergence.format_rows(rows))
    ok = convergence.passes(rows)
    print(f"check convergence {CONVERGENCE} PSNR at epochs "
          f"{sorted(CONVERGENCE_BARS)} >= {CONVERGENCE_BARS} dB [{card}] "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"convergence: below {CONVERGENCE_BARS} dB")
    print(f"check convergence (a) chain-kernel launches: {chain} "
          f"{'OK' if not any(chain.values()) else 'FAIL'}")
    if any(chain.values()):
        raise AssertionError("convergence (a): a chain kernel launched")
    ds = load_dataset_nerf(cfg.dataset.n_perspectives,
                           f"{cfg.dataset.path}/train")
    gen = train_nerf.MVNeRFDataGenerator(
        ds, n_rays_train=nm.n_rays_train, batch_size=nt.batch_size,
        n_views=1, rng=5, exclude_perspectives=(cfg.valid_perspective_tgt_idx,))
    batch = to_device(*gen[0], dev)
    print("convergence (a) profiled train step:")
    device_time_by_kernel(
        lambda: T.nerf_train_step(state, *batch,
                                  torch.Generator(device=dev).manual_seed(8)),
        card, top=6)
    del state, batch
    torch.cuda.empty_cache()

    full = config.load_config([data_dir, *FULL_CONVERGENCE_CUT],
                              "nerf_convergence")
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    (state, history), wall = timed(lambda: train_nerf._main(full, dev))
    peak = torch.cuda.max_memory_allocated(dev)
    counts = read_counts()
    k2 = counts.get(CHAIN_COUNTS["K2"], 0)
    launches["K2 convergence"] = k2
    steps = history["steps"]
    print(f"convergence (b): nerf_convergence at full width, cut "
          f"{FULL_CONVERGENCE_CUT}: {len(steps)} step(s) of batch "
          f"{full.nerf_training.batch_size} (loss "
          f"{[round(st['loss'], 6) for st in steps]}, "
          f"{[round(1e3 * st['step_s'], 1) for st in steps]} ms) and "
          f"validations {[(e, round(float(v), 3)) for e, v in history['valid']]}"
          f" dB in {wall:.1f} s (dataset synthesis included), peak "
          f"{peak / 2 ** 30:.2f} GiB; the JAX record at epoch 0: 14.565 dB "
          f"(other weights); launches {counts} [{card}]")
    ok = (len(steps) == 2 and all(np.isfinite(st["loss"]) for st in steps)
          and len(history["valid"]) == 2
          and all(np.isfinite(v) for _, v in history["valid"]) and k2 > 0)
    print(f"check convergence (b): two finite steps, two finite "
          f"validations, {k2} K2 launches {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("convergence (b): nerf_convergence failed")
    seeded = train_nerf.build_model(full, dev)
    moved = {"nerf": [0, 0], "feature": [0, 0], "frozen": [0, 0]}
    for (n, p), q in zip(state.model.named_parameters(),
                         seeded.parameters()):
        group = moved[T.param_group(n)]
        group[0] += not torch.equal(p.detach(), q.detach())
        group[1] += 1
    ok = (moved["nerf"][0] > 0 and moved["feature"][0] > 0
          and moved["frozen"][0] == 0)
    print(f"check convergence (b) update: tensors moved from the seeded "
          f"weights after 2 steps, per group [moved, of]: {moved} "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("convergence (b): the full-width fit did not "
                             "update both parameter groups")
    del state, seeded
    torch.cuda.empty_cache()

    trace_dir = root / "trace"
    traced = config.load_config(
        [data_dir, f"nerf_training.model_path={root / 'trace_run'}",
         *TRACE_CUT], CONVERGENCE)
    os.environ["TCNERF_TRACE"] = str(trace_dir)
    try:
        (_, history), wall = timed(lambda: train_nerf._main(traced, dev))
    finally:
        del os.environ["TCNERF_TRACE"]
    files = sorted(trace_dir.iterdir())
    events = []
    if len(files) == 1:
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    ok = len(files) == 1 and kernels > 0 and len(history["steps"]) == 2
    print(f"check convergence (c) TCNERF_TRACE: {len(files)} file(s) "
          f"({', '.join(f'{p.name} {p.stat().st_size} bytes' for p in files)})"
          f", {len(events)} events, {kernels} CUDA kernel events, run "
          f"{wall:.1f} s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("convergence (c): no CUDA kernel in the trace")


# phase_grasp_convergence: a cut of the grasp-stage fits (PERF.md §5's
# long runs of nerf_convergence_cpu, goal_convergence_cpu), sized from the
# long run to ~120 s on the card: 64 backbone epochs (256 steps), 24 goal
# epochs (768 steps, three validation rounds), the full strong ascent. The
# long run's goal rounds over its first 64 epochs sat at 83-289 mm best
# error, one of eight below half the untrained strong error, so no cut of
# ~120 s holds the tool's 0.5 ratio: the ratio is printed, and the phase
# holds the structural check (finite errors, every round present, trained
# below untrained)
GRASP_CONVERGENCE = "goal_convergence_cpu"
GRASP_BACKBONE_CUT = ["nerf_training.n_epochs=64"]
GRASP_CONVERGENCE_CUT = ["grasp_training.n_epochs=24"]
GRASP_STRONG_CUT = dict(n_guesses=1024, n_steps=32)
GRASP_RATIO = 0.5
# then `language_convergence_cpu` (fusion v4, train_fusion, batch 2) on the
# same backbone for one validation round (8 epochs, 256 steps); its errors
# are printed beside the untrained readout's at the round's own ascent
# (256 guesses, 16 steps in turn), with no bar: the JAX record at full
# width is flat through epoch 16
LANGUAGE_CONVERGENCE = "language_convergence_cpu"
LANGUAGE_CONVERGENCE_CUT = ["grasp_training.n_epochs=8"]
LANGUAGE_STRONG_CUT = dict(n_guesses=256, n_steps=16)


def phase_grasp_convergence(dev, card, launches, root):
    """The grasp stage's trained quality on the card, cut
    (`tools/convergence.py`): `nerf_convergence_cpu` fit to
    GRASP_BACKBONE_CUT, then `goal_convergence_cpu` on that backbone to
    GRASP_CONVERGENCE_CUT (every validation round of 256 guesses, 16
    steps). The round pickles read back through `read_grasp_rounds` as
    the session logged them; `best` loads onto the card and stores again
    to the same bytes; the strong validation at GRASP_STRONG_CUT, trained
    (`best`) and untrained (the readout seeded from `seed`), printed
    beside the JAX record with the controlled ratio (trained
    `best_r_error_mean_t` at most GRASP_RATIO of the untrained one),
    which the cut does not hold (see GRASP_CONVERGENCE); held: finite
    errors and the trained `best_r_error_mean_t` below the untrained one.
    No chain kernel launches (hidden 64: the plain chain, as in JAX)."""
    import numpy as np
    from tcnerf_torch.models import checkpoint as ckpt
    from tcnerf_torch.tools import convergence
    from tcnerf_torch.train import grasp_common

    data_dir = f"data_dir={root / 'grasp_convergence'}"
    reset_counts()
    backbone, _, _ = convergence.fit("nerf_convergence_cpu",
                                     [data_dir, *GRASP_BACKBONE_CUT])
    print(convergence.format_rows([r for r in convergence.compare(
        convergence.read_metrics(backbone.nerf_training.model_path),
        convergence.read_metrics(
            convergence.record_path("nerf_convergence_cpu")))
        if r["psnr_db"] is not None]))
    overrides = [data_dir, *GRASP_CONVERGENCE_CUT]
    cfg, _, history = convergence.fit(GRASP_CONVERGENCE, overrides)
    gt = cfg.grasp_training
    rounds = convergence.read_grasp_rounds(gt.model_path)
    print(f"grasp convergence rounds of {GRASP_CONVERGENCE}, cut "
          f"{GRASP_CONVERGENCE_CUT} on nerf_convergence_cpu cut "
          f"{GRASP_BACKBONE_CUT} [{card}]:")
    print(convergence.format_grasp_rounds(rounds))
    logged = {e: d for e, d, _ in history["valid"] if e is not None}
    want = list(range(gt.eval_after_epochs, gt.n_epochs + 1,
                      gt.eval_after_epochs))
    ok = (list(rounds) == sorted(logged) == want and all(
        np.isfinite(v) and np.isclose(v, logged[e][k], rtol=1e-12, atol=0)
        for e, row in rounds.items() for k, v in row.items()))
    print(f"check grasp convergence rounds: {list(rounds)} read back as "
          f"logged {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("grasp convergence: the round pickles do not "
                             "read back as the session logged them")

    best = os.path.join(gt.model_path, "best")
    again = str(root / "grasp_convergence_best_again")
    model = grasp_common.build_grasp_model(cfg, device=dev)
    ok = ckpt.load(best, model, ckpt.GRASP_COMPONENTS)
    ckpt.store(again, model, ckpt.GRASP_COMPONENTS)
    names = [c for c in ckpt.GRASP_COMPONENTS
             if os.path.exists(ckpt.component_path(best, c))]
    for c in names:
        with open(ckpt.component_path(best, c), "rb") as f, \
                open(ckpt.component_path(again, c), "rb") as g:
            ok = ok and f.read() == g.read()
    print(f"check grasp convergence best: {names} onto the card and stored "
          f"again, the same bytes {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("grasp convergence: best does not load back "
                             "bit for bit")
    del model

    strong = convergence.controlled_strong(
        GRASP_CONVERGENCE, gt.model_path, gt.backbone_path, overrides, dev,
        **GRASP_STRONG_CUT)
    print(convergence.format_strong(GRASP_CONVERGENCE, strong,
                                    GRASP_STRONG_CUT["n_guesses"],
                                    GRASP_STRONG_CUT["n_steps"]))
    counts = read_counts()
    chain = {k: counts.get(key, 0) for k, key in CHAIN_COUNTS.items()}
    print(f"check grasp convergence chain-kernel launches: {chain} "
          f"{'OK' if not any(chain.values()) else 'FAIL'}")
    if any(chain.values()):
        raise AssertionError("grasp convergence: a chain kernel launched")
    t, u = (strong[k]["best_r_error_mean_t"] for k in ("trained",
                                                       "untrained"))
    print(f"grasp convergence ratio (not held at this cut): trained best "
          f"{t:.2f} mm {'<=' if t <= GRASP_RATIO * u else '>'} "
          f"{GRASP_RATIO} x untrained {u:.2f} mm")
    finite = all(np.isfinite(v) for r in strong.values()
                 for k, v in r.items() if k != "epoch")
    ok = finite and t < u
    print(f"check grasp convergence: finite strong errors, trained best "
          f"{t:.2f} mm below untrained {u:.2f} mm [{card}] "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grasp convergence: trained {t:.2f} mm not "
                             f"below untrained {u:.2f} mm")
    language_convergence(dev, card, data_dir)


def language_convergence(dev, card, data_dir):
    """`language_convergence_cpu` fitted to LANGUAGE_CONVERGENCE_CUT on the
    phase's backbone (`train_fusion`: the V4 decoder trains with the
    readout). Held: finite step metrics; the trainable tensors are the
    readout's and V4's, and every one of them moved; every other tensor
    bit for bit the seeded model's with the backbone loaded; the round
    pickle read back as logged, with finite designated-target errors; no
    chain kernel. The round and the untrained readout at
    LANGUAGE_STRONG_CUT are printed, not held."""
    import numpy as np
    import torch
    from tcnerf_torch.tools import convergence
    from tcnerf_torch.train import grasp_common

    t0 = time.perf_counter()
    reset_counts()
    overrides = [data_dir, *LANGUAGE_CONVERGENCE_CUT]
    cfg, state, history = convergence.fit(LANGUAGE_CONVERGENCE, overrides)
    gt = cfg.grasp_training
    finite = all(np.isfinite(v) for s in history["steps"]
                 for v in s.values())
    seeded = grasp_common.build_grasp_model(cfg, fusion=gt.fusion,
                                            device=dev)
    grasp_common.load_backbone(seeded, cfg, fusion=True)
    trained = set(state.names)
    groups = ("grasp_readout", "combine_clip_visual")
    moved = dict.fromkeys(groups, 0)
    still, same = [], 0
    for (n, p), q in zip(state.model.named_parameters(),
                         seeded.parameters()):
        if n in trained:
            if torch.equal(p, q):
                still.append(n)
            else:
                moved[n.split(".")[0]] += 1
        elif torch.equal(p, q):
            same += 1
        else:
            raise AssertionError(f"language convergence: frozen {n} changed")
    del seeded
    ok = finite and not still and {
        n.split(".")[0] for n in trained} == set(groups)
    print(f"check language convergence ({LANGUAGE_CONVERGENCE}, cut "
          f"{LANGUAGE_CONVERGENCE_CUT}, train_fusion): "
          f"{len(history['steps'])} steps, finite metrics {finite}; moved "
          f"tensors {moved} of {len(trained)} trainable, unmoved {still}; "
          f"{same} others bit for bit the seeded model's with the backbone "
          f"loaded [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("language convergence: not finite, a trainable "
                             f"tensor did not move ({still}), or the "
                             "trainable tensors are not the V4 decoder's "
                             "and the readout's")
    rounds = convergence.read_grasp_rounds(gt.model_path)
    logged = {e: d for e, d, _ in history["valid"] if e is not None}
    ok = (list(rounds) == sorted(logged) == [gt.n_epochs] and all(
        np.isfinite(v) and np.isclose(v, logged[e][k], rtol=1e-12, atol=0)
        for e, row in rounds.items() for k, v in row.items()))
    print(convergence.format_grasp_rounds(rounds))
    print(f"check language convergence rounds: {list(rounds)} read back as "
          f"logged, finite designated-target errors "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("language convergence: the round pickle does "
                             "not read back as logged")
    untrained = convergence.strong_validate(
        LANGUAGE_CONVERGENCE, gt.model_path, gt.backbone_path, overrides,
        dev, checkpoint=None, **LANGUAGE_STRONG_CUT)
    r = rounds[gt.n_epochs]
    print(f"language convergence after {gt.n_epochs} epochs (not held): "
          f"mean {r['mean_r_error_t']:.2f} mm, top-1 "
          f"{r['best_r_error_mean_t']:.2f} mm; untrained readout "
          f"({LANGUAGE_STRONG_CUT['n_guesses']} guesses, "
          f"{LANGUAGE_STRONG_CUT['n_steps']} steps in turn, rng 0): mean "
          f"{untrained['mean_r_error_t']:.2f} mm, top-1 "
          f"{untrained['best_r_error_mean_t']:.2f} mm [{card}]")
    counts = read_counts()
    chain = {k: counts.get(key, 0) for k, key in CHAIN_COUNTS.items()}
    ok = not any(chain.values())
    print(f"check language convergence chain-kernel launches: {chain} "
          f"{'OK' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s "
          f"added to the phase")
    if not ok:
        raise AssertionError("language convergence: a chain kernel "
                             "launched")


def phase_demos(dev, card):
    """The two demos on the card through their functions: the CLIP demo at
    224^2 (full-size random towers; 3 x 3 finite probabilities, rows
    summing to 1) and the pipeline demo (64 guesses, 4 steps; 5 poses with
    finite energies, best first)."""
    import numpy as np
    from tcnerf_torch.clip import demo
    from tcnerf_torch.models import pipeline

    probs, wall = timed(lambda: demo.main(["--size", "224"]))
    ok = (probs.shape == (3, 3) and np.isfinite(probs).all()
          and np.allclose(probs.sum(axis=1), 1.0, atol=1e-5))
    print(f"check demo clip (224^2, random RN50 and text towers): rows sum "
          f"to {probs.sum(axis=1).tolist()}, {wall:.2f} s "
          f"{'OK' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("demo clip: bad probabilities")
    result, wall = timed(lambda: pipeline._demo(device=dev))
    ok = (len(result.poses) == 5 and np.isfinite(result.scores).all()
          and np.isfinite(result.all_energies).all()
          and result.scores == sorted(result.scores, reverse=True))
    print(f"check demo pipeline: {len(result.all_energies)} guesses, top "
          f"{len(result.poses)} energies {[round(x, 4) for x in result.scores]}"
          f", {wall:.2f} s {'OK' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("demo pipeline: bad energies")


PARALLEL_CHUNK = 4096


def _same(name, got, want):
    """Bit-identical tensors, or an AssertionError with the largest gap."""
    ok = got.shape == want.shape and bool((got == want).all())
    gap = float((got.double() - want.double()).abs().max())
    print(f"check parallel {name}: bit for bit {'OK' if ok else 'FAIL'} "
          f"(max |diff| {gap:.6g})")
    if not ok:
        raise AssertionError(f"parallel {name} differs")


def parallel_render(mesh, dev, card, launches):
    """(a) The sharded full-image render at bench_sharded's configuration
    (480x640, 1 view, bf16, pallas_mlp: K1 in both chain halves, n_features
    256, 6 blocks, 64+64 samples, random bf16 features, camera_ring(2),
    4096-ray chunks) against render_all_rays with one generator seed: the
    same bits and as many K1 launches; then 3 timed runs of each, in
    turns."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tcnerf_torch.data.synthetic import camera_ring
    from tcnerf_torch.models import inference
    from tcnerf_torch.parallel.serve import render_image_sharded

    model = build_model(dev, dtype=torch.bfloat16, pallas_mlp=True)
    rng = np.random.default_rng(6)
    cfg, tgt = camera_ring(2, height=H, width=W)[:2]
    k4 = np.eye(4, dtype=np.float32)
    k4[:3, :3] = cfg["intrinsics"].reshape(3, 3)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    gen = torch.Generator(device=dev).manual_seed(6)
    feats = torch.randn((1, 1, H, W, 256), generator=gen, device=dev
                        ).to(torch.bfloat16)
    args = (model, f32(rng.uniform(size=(1, 1, H, W, 3))), f32(k4[None, None]),
            f32(np.linalg.inv(cfg["pose"])[None, None]), feats,
            f32(tgt["pose"]), f32(tgt["intrinsics"].reshape(3, 3)), H, W,
            PARALLEL_CHUNK)
    paths = {"sharded": functools.partial(render_image_sharded, mesh),
             "render_all_rays": inference.render_all_rays}

    def run(name):
        with torch.no_grad():
            return paths[name](*args, generator=torch.Generator(
                device=dev).manual_seed(9))

    outs, counts, first = {}, {}, {}
    for name in paths:
        reset_counts()
        outs[name], first[name] = timed(lambda: run(name))
        counts[name] = read_counts().get("resmlp_rows", 0)
    launches["K1 parallel"] = counts["sharded"]
    for i, part in enumerate(("fine_rgb", "fine_depth")):
        _same(f"render {H}x{W} {part} vs render_all_rays",
              outs["sharded"][i], outs["render_all_rays"][i])
    if not counts["sharded"] == counts["render_all_rays"] > 0:
        raise AssertionError(f"parallel render K1 launches {counts}")
    times = {name: [] for name in paths}
    for _ in range(3):
        for name in paths:
            times[name].append(timed(lambda: run(name))[1])
    med = {name: float(np.median(t)) for name, t in times.items()}
    print(f"parallel render {H}x{W} at world size 1 ({dist.get_backend()}), "
          f"chunk "
          f"{PARALLEL_CHUNK}: sharded {med['sharded'] * 1e3:.1f} ms "
          f"({H * W / med['sharded']:.0f} rays/s), render_all_rays "
          f"{med['render_all_rays'] * 1e3:.1f} ms "
          f"({H * W / med['render_all_rays']:.0f} rays/s), difference "
          f"{(med['sharded'] - med['render_all_rays']) * 1e3:+.1f} ms "
          f"(medians of {[round(x * 1e3, 1) for x in times['sharded']]} / "
          f"{[round(x * 1e3, 1) for x in times['render_all_rays']]}; first "
          f"calls {first['sharded'] * 1e3:.1f} / "
          f"{first['render_all_rays'] * 1e3:.1f} ms); K1 launches "
          f"{counts['sharded']} / {counts['render_all_rays']} [{card}]")
    del model, feats, outs


def parallel_ascent(mesh, dev, card):
    """(b) `goal_1_view` at full width (4096 guesses, 3 images, phase_grasp's
    scene): the energies of each rank's block of guesses and the explicit
    ascent gradients, gathered, against the plain PoseOptimizer energies
    and autograd of the whole, bit for bit."""
    import torch
    from tcnerf_torch.models.pipeline import GraspPipeline
    from tcnerf_torch.opt.pose_optimizer import frozen
    from tcnerf_torch.parallel.explicit import (gather_guesses,
                                                make_explicit_ascent_step)
    from tcnerf_torch.parallel.mesh import pose_shardings
    from tcnerf_torch.train import config
    from tcnerf_torch.train.grasp_common import build_grasp_model

    cfg = config.load_config([], "goal_1_view")
    opt_cfg = cfg.validation.grasp_opt_config.optimizer_config
    model = build_grasp_model(cfg, device=dev)
    pipe = GraspPipeline(model=model, params=None,
                         workspace_bounds=cfg.generator_grasp.workspace_bounds,
                         n_initial_guesses=opt_cfg.n_initial_guesses,
                         n_images=opt_cfg.n_images)
    opt = pipe._ensure_optimizer()
    scene = grasp_scene(opt_cfg.n_images, seed=2)
    sc = opt.prepare(scene, pipe.encode(scene[0]))
    guesses = opt.generate_initial_guesses(0)
    whole = opt.init_state(guesses)
    block = opt.init_state([pose_shardings(mesh).local(g).cpu().numpy()
                            for g in guesses])
    _same(f"ascent energies of {opt_cfg.n_initial_guesses} guesses",
          gather_guesses(opt.compute_current_grasp_success(block, sc), mesh,
                         dim=0),
          opt.compute_current_grasp_success(whole, sc))

    energy_fn = opt._energies
    ascent = make_explicit_ascent_step(mesh, energy_fn)
    with frozen(model):
        t = whole.translations.detach().requires_grad_(True)
        r = whole.rotations.detach().requires_grad_(True)
        with torch.enable_grad():
            want = torch.autograd.grad(-energy_fn(t, r, sc).sum(), (t, r))
        (got_t, got_r), secs = timed(
            lambda: ascent(whole.translations, whole.rotations, sc))
    for name, got, w in (("dE/dt", got_t, want[0]), ("dE/dr", got_r, want[1])):
        _same(f"explicit ascent {name}", gather_guesses(got, mesh), w)
    print(f"parallel ascent: one explicit gradient step of "
          f"{opt_cfg.n_initial_guesses} guesses x {opt_cfg.n_images} images "
          f"{secs * 1e3:.1f} ms (first call) [{card}]")
    del pipe, model, opt, sc


PARALLEL_UPDATE_BAR = 2e-2


def deterministic_algorithms(on: bool):
    """Turn torch's deterministic mode on or off (cuBLAS asks for
    CUBLAS_WORKSPACE_CONFIG while it is on; the memory-efficient attention
    and the indexing backward then take their deterministic algorithms)."""
    import torch
    if on:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(on)


def parallel_train(mesh, dev, card, launches, root):
    """(c) `nerf_1_view_wo` (f32, pallas_mlp: K1' in the chain halves) at
    batch 8 x 512 rays on phase_train's dataset: the sharded step and the
    explicit step (with this rank's block of the global draws) against
    `nerf_train_step` on copies of the model with the same draws, two
    updates on the same batch with a warm-up of one step (the first at
    learning rate 0, filling Adam's moments; the second at the full rate),
    a second `nerf_train_step` run as the control. First in torch's
    default mode, whose backward adds with atomics (the indexing backward,
    the memory-efficient attention), so that runs differ: held are the
    first loss bit for bit, Adam's moments after the first update at 1e-5
    of their largest entry (the gradients) and the parameters after the
    second update at a relative L2 distance from nerf_train_step's of at
    most PARALLEL_UPDATE_BAR of the update's L2 norm (Adam's update is
    about lr x sign(grad)). Then in torch's deterministic mode, where the
    loss, the moments and every parameter after the second update must
    be nerf_train_step's bit for bit."""
    import copy

    import torch
    from tcnerf_torch.data.generators import MVNeRFDataGenerator, to_device
    from tcnerf_torch.data.loaders import load_dataset_nerf
    from tcnerf_torch.models import training as T
    from tcnerf_torch.parallel.explicit import make_explicit_train_step
    from tcnerf_torch.parallel.mesh import (RAY_SPEC, Sharding,
                                            nerf_train_step_sharded,
                                            shard_nerf_batch, shard_params)
    from tcnerf_torch.train import config, train_nerf

    data_dir = REPO / "build" / "chip_smoke_train"
    cfg = config.load_config([f"data_dir={data_dir}", *TRAIN_CUT,
                              f"nerf_training.model_path={root / 'par'}"],
                             "nerf_1_view_wo")
    base = train_nerf.build_model(cfg, dev)
    before = torch.cat([p.detach().reshape(-1) for p in base.parameters()])
    b, r = cfg.nerf_training.batch_size, cfg.nerf_model.n_rays_train
    ds = load_dataset_nerf(cfg.dataset.n_perspectives,
                           f"{cfg.dataset.path}/train")
    batch = to_device(*MVNeRFDataGenerator(
        ds, n_rays_train=r, batch_size=b, n_views=1, rng=1)[0], dev)
    draws = T.draw_samples(base, b, r, torch.Generator(
        device=dev).manual_seed(7), dev)
    local = shard_nerf_batch(*batch, mesh)
    local_draws = tuple(Sharding(mesh, RAY_SPEC).local(u) for u in draws)
    explicit = make_explicit_train_step(mesh)
    steps = {
        "nerf_train_step": lambda s: T.nerf_train_step(s, *batch,
                                                       draws=draws),
        "control": lambda s: T.nerf_train_step(s, *batch, draws=draws),
        "sharded": lambda s: nerf_train_step_sharded(s, *local, mesh,
                                                     draws=draws),
        "explicit": lambda s: explicit(s, *local, draws=local_draws)}

    def run(name, step):
        model = copy.deepcopy(base)
        state = T.create_train_state(
            model, T.make_nerf_optimizer(model, warmup_steps=1))
        if name in ("sharded", "explicit"):
            shard_params(state.model, state.optimizer, mesh)
        reset_counts()
        (_, metrics), secs = timed(lambda: step(state))
        k1d = read_counts().get("resmlp_rows_diff", 0)
        moments = torch.cat([torch.cat([v["exp_avg"].reshape(-1),
                                        v["exp_avg_sq"].reshape(-1)])
                             for v in state.optimizer.adam.state.values()])
        step(state)
        return metrics["loss"], state.model, moments, secs, k1d

    for deterministic in (False, True):
        mode = "deterministic" if deterministic else "default"
        deterministic_algorithms(deterministic)
        try:
            results = {name: run(name, step) for name, step in steps.items()}
        finally:
            deterministic_algorithms(False)
        want_loss, want_model, want_m, _, want_k = results["nerf_train_step"]
        if not deterministic:
            launches["K1' parallel"] = results["sharded"][4]
        want_p = torch.cat([p.detach().reshape(-1)
                            for p in want_model.parameters()])
        norm = float((want_p - before).norm())

        def update_gap(model):
            got = torch.cat([p.detach().reshape(-1)
                             for p in model.parameters()])
            return float((got - want_p).norm()) / norm

        control_m = float((results["control"][2] - want_m).abs().max())
        control_p = update_gap(results["control"][1])
        for name in ("sharded", "explicit"):
            loss, model, moments, secs, k1d = results[name]
            _same(f"{name} train step loss ({mode} mode)", loss, want_loss)
            got = dict(model.named_parameters())
            same = sum(torch.equal(p, got[n])
                       for n, p in want_model.named_parameters())
            gap_m = float((moments - want_m).abs().max())
            gap_p = update_gap(model)
            if deterministic:
                bar_m, bar_p = 0.0, 0.0
                ok = same == len(got)
            else:
                bar_m = 1e-5 * float(want_m.abs().max())
                bar_p = PARALLEL_UPDATE_BAR
                ok = True
            ok = (ok and k1d == want_k > 0 and gap_m <= bar_m
                  and gap_p <= bar_p)
            print(f"check parallel {name} train step ({mode} mode): Adam "
                  f"moments after the first update max |diff| "
                  f"{gap_m:.6g}, limit {bar_m:.6g} (control "
                  f"{control_m:.6g}); params after the second update rel. "
                  f"L2 distance {gap_p:.6g} of the update (norm "
                  f"{norm:.6g}), limit {bar_p} (control {control_p:.6g}), "
                  f"{same} of {len(got)} tensors bit for bit; K1' launches "
                  f"{k1d} / {want_k}; {secs * 1e3:.1f} ms (first call) "
                  f"[{card}] {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"parallel {name} train step differs ({mode} mode): "
                    f"moments {gap_m:.6g}, params {gap_p:.6g}, {same} of "
                    f"{len(got)} tensors bit for bit")
        del results, want_model
    del base


def phase_parallel(dev, card, launches, root):
    """The parallel package at world size 1 on the card (one NCCL rank):
    `parallel.dryrun.rank_checks` at tiny widths, then (a) the sharded
    render and (b) the sharded ascent at full width against their
    one-process versions bit for bit, (c) the sharded and explicit train
    steps against `nerf_train_step` (see parallel_train), and (d)
    `host_shard_indices`. The group is destroyed at the end."""
    import numpy as np
    import torch.distributed as dist
    from tcnerf_torch.parallel import dryrun
    from tcnerf_torch.parallel.distributed import host_shard_indices
    from tcnerf_torch.parallel.mesh import destroy_mesh, make_mesh

    mesh = make_mesh(1, device=dev)
    try:
        print(f"parallel: make_mesh(1) on {dev.type}: {mesh}, backend "
              f"{dist.get_backend()}")
        (out, secs) = timed(lambda: dryrun.rank_checks(
            mesh, dryrun.tiny_case(), dev))
        print(f"check parallel {out['summary']} ({secs:.1f} s)")
        parallel_render(mesh, dev, card, launches)
        parallel_ascent(mesh, dev, card)
        parallel_train(mesh, dev, card, launches, root)
        got = [host_shard_indices(10), host_shard_indices(10, rng=3)]
        want = np.arange(10)
        ok = (np.array_equal(got[0], want)
              and np.array_equal(np.sort(got[1]), want))
        print(f"check parallel host_shard_indices at world size 1: "
              f"{got[0].tolist()}, shuffled {got[1].tolist()} "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("host_shard_indices at world size 1")
    finally:
        destroy_mesh()


KERNELS = {
    "K1": dict(name="resmlp_rows", source="tcnerf_torch/csrc/resmlp.cu",
               replaces="tcnerf/ops/pallas/resmlp.py:137",
               mode="skip_input chain half, f32 stream, bf16 in/out "
                    "(MVResNetMLPEmbedding._pallas_chain), 1048576x128"),
    "K2": dict(name="swg_gather_mlp_t", source="tcnerf_torch/csrc/swg.cu",
               replaces="tcnerf/ops/pallas/swg.py:246",
               mode="head inside, bf16 stream, fine stage 1048576 queries"),
    "K3": dict(name="swg_gather_mlp", source="tcnerf_torch/csrc/swg.cu",
               replaces="tcnerf/ops/pallas/swg.py:362",
               mode="head given, f32 stream, fine stage 1048576 queries"),
    "P1": dict(name="probe_fwd_kernel", source="tcnerf_torch/csrc/probe.cu",
               replaces="none: the port's own (the energy's probe rows, which "
                        "the JAX package leaves to XLA)",
               mode="tap, encoding, chain and per-probe readout, f32 FFMA, "
                    "goal_1_view 516096 rows"),
    "P2": dict(name="probe_bwd_kernel", source="tcnerf_torch/csrc/probe.cu",
               replaces="none: the port's own (as P1)",
               mode="d(xy, position, direction) from d(out), f32 FFMA, "
                    "goal_1_view 516096 rows"),
    "K1'": dict(name="resmlp_rows_diff", source="tcnerf_torch/csrc/resmlp.cu",
                replaces="tcnerf/ops/pallas/resmlp.py:180",
                mode="training: K1 forward (f32 stream, f32 in/out, bf16 "
                     "weight copies, 3-block chain half), fine chunk "
                     "131072x128; backward plain (recompute + autograd)"),
}


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "tcnerf_torch" / "csrc").is_dir():
        print(f"chip_smoke: tcnerf_torch/ not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from tcnerf_torch.data.synthetic import camera_ring
    from tcnerf_torch.device import resolve_device
    from tcnerf_torch.tools.common import device_line

    dev = resolve_device("cuda")
    card = device_line(dev)
    print(card)
    phase_build()
    kres = phase_kernels(dev, card)
    launches = {}
    if "--kernels" in argv:
        phase_gather(dev, card, launches)
        return 0
    phase_sweep(dev, card)
    src_cfg, tgt_cfg = camera_ring(2, height=H, width=W)
    src = np.random.default_rng(0).integers(0, 256, (H, W, 3), dtype=np.uint8)
    scene = (src, src_cfg, tgt_cfg)
    phase_serve(dev, card, scene, launches)
    phase_flax(dev, card, scene, launches)
    phase_f32(dev, card, scene, launches)
    phase_serve_clip(dev, card, scene, launches)
    phase_serve_3view(dev, card, launches)
    # after the serving phases, which thus run as they did before it existed
    kres.update(phase_gather(dev, card, launches))
    # every checkpoint goes under one root outside the repository, removed
    # at the end of the run
    root = Path(tempfile.mkdtemp(prefix="tcnerf_chip_smoke_"))
    try:
        kres.update(timed_stores(
            lambda: phase_train(dev, card, launches, root), "phase_train",
            card))
        fused_final = timed_stores(
            lambda: phase_train_fused(dev, card, launches, root),
            "phase_train_fused", card)
        phase_grasp(dev, card, launches=launches)
        phase_grasp_language(dev, card, launches)
        timed_stores(lambda: phase_grasp_train(dev, card, launches, root),
                     "phase_grasp_train", card)
        timed_stores(lambda: phase_checkpoint(dev, card, launches, root,
                                              scene, fused_final),
                     "phase_checkpoint", card)
        timed_stores(lambda: phase_hashgrid(dev, card, launches, root),
                     "phase_hashgrid", card)
        timed_stores(lambda: phase_collect(dev, card, launches, root),
                     "phase_collect", card)
        timed_stores(lambda: phase_convergence(dev, card, launches, root),
                     "phase_convergence", card)
        timed_stores(lambda: phase_grasp_convergence(dev, card, launches,
                                                     root),
                     "phase_grasp_convergence", card)
        phase_demos(dev, card)
        phase_parallel(dev, card, launches, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows = []
    for k, r in kres.items():          # K1-K3, then K4-K13 from the tools
        meta = KERNELS.get(k, r)
        rows.append({"name": meta["name"], "route": "cuda",
                     "source": meta["source"], "replaces": meta["replaces"],
                     "mode": meta["mode"], "launches": launches[k],
                     "max_abs_err": r["err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1],
                     # the same kernel's launches on the other paths: the
                     # CLIP-fused views, the fused trainers, their
                     # validation renders
                     **{f"launches_{key.split(' ', 1)[1]}": n
                        for key, n in launches.items()
                        if key.startswith(f"{k} ")},
                     # no single PyTorch call computes K1-K3's fused chain
                     "library_ms": r.get("library_ms"),
                     **{key: r[key] for key in ("coarse_ms", "backward_ms",
                                                "coarse_backward_ms",
                                                "executed_flops", "keep_ms")
                        if key in r}})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
