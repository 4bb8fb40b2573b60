"""Novel views through `render_view`, one client in a closed loop.

Request i is a new seeded uint8 source image and a target camera on a
ring (`lib/scenes.py` `view_request`); `render_view` takes its default
path on the card, the configuration's chunk (8192 rays, the card's default)
and a torch generator seeded for the request,
and returns uint8 rgb and depth on the host. A request's service time runs
from the call to its return; the client makes its inputs outside it.

The check, once the program is freed: for `check_requests` requests drawn
from the seed, the plain reference (`reference/nerf.py`) renders the same
view from the same weights, image and cameras, with the draws of the same
generator in the program's chunk order, twice: in float32, and with the
MLP's products in fp8 (e4m3, per-tensor scale), the nearest precision below
the serving path's bfloat16. The number compared: rgb_off_2_over_fp8, the
share of the checked views' pixel channels whose uint8 value is off from
the float32 reference's by 2 levels or more, over the same share of the
fp8 rendition (at least 0.01). How far bf16 or fp8 moves a uint8 level
depends on the content (a dark image moves a tenth as many channels as a
mid-grey one), and the ratio takes the views' own sensitivity out: a
program at bf16 reads a few hundredths, one at fp8 about 1. Also reported:
the shares off by 2, 3 and 4, the fp8 rendition's share off by 2, and per
view the mean and 99th percentile of the rgb gap and the mean depth gap,
worst view.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.lib import harness, port, scenes, weights
from benchmark.lib import work as arithmetic


def setup(ctx):
    c, dev = ctx.config, ctx.device
    from tcnerf_torch.device import resolve_device
    from tcnerf_torch.train.train_nerf import build_model

    resolve_device(dev)      # fp32 pinned, as the port's entry points do
    cfg = port.load(c)
    model = build_model(cfg, dev)
    weights.load_into(model, weights.for_module(model, ctx.seed, dev))
    if "bias_dropped" in ctx.faults:
        weights.drop_biases(model)
    model.eval()
    plant_faults(ctx.faults)
    state = SimpleNamespace(ctx=ctx, model=model, outputs={})
    for i in range(int(ctx.traffic.get("warmup_units", 0))):
        unit(state, i)
    state.outputs.clear()
    return state


def generator_seed(state, i: int) -> int:
    return scenes.derived_seed(state.ctx.seed, "draws", i)


def unit(state, i: int) -> dict:
    c, dev = state.ctx.config, state.ctx.device
    h, w = c["image_size"]
    image, src, tgt = scenes.view_request(state.ctx.seed, i, h, w)
    gen = torch.Generator(device=dev).manual_seed(generator_seed(state, i))
    from tcnerf_torch.models import inference
    t0 = time.perf_counter()
    rgb, depth = inference.render_view(state.model, [image], [src], tgt,
                                       generator=gen, chunk=c["chunk"],
                                       device=dev)
    dt = time.perf_counter() - t0
    state.outputs[i] = (rgb, depth)
    return {"service_s": dt, "latency_s": dt,
            "failed": rgb.shape != (h, w, 3)}


def work(state) -> dict:
    c = state.ctx.config
    h, w = c["image_size"]
    return {"flops": arithmetic.view_flops(c),
            "chunks": arithmetic.chunk_work(h, w, c["n_samples"], c["hidden"],
                                            c["n_blocks"])}


def finish(state) -> None:
    state.model = None


def check(state) -> dict:
    from benchmark.reference import layers as ref_layers
    from benchmark.reference import nerf as ref

    ctx, c = state.ctx, state.ctx.config
    dev = ctx.device
    h, w = c["image_size"]
    done = sorted(state.outputs)
    n = min(int(ctx.traffic.get("check_requests", 2)), len(done))
    pick = scenes.stream(ctx.seed, "sample").choice(done, size=n,
                                                    replace=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lower = ctx.control.get("reference_lower")
    model = ref.Renderer(c).to(dev)
    weights.load_into(model, weights.for_module(model, ctx.seed, dev))
    worst, off, total = {}, {k: 0 for k in SHARES}, 0
    fp8_off = 0
    for i in pick:
        image, src, tgt = scenes.view_request(ctx.seed, int(i), h, w)
        views = {}
        for mode in (None, "fp8"):
            ref_layers.LOWER["mode"] = mode
            gen = torch.Generator(device=dev).manual_seed(
                generator_seed(state, int(i)))
            views[mode] = ref.render_view(model, image, src, tgt, gen,
                                          c["chunk"])
        ref_layers.LOWER["mode"] = None
        rgb_r, depth_r = views[None]
        # the control: the reference in fp8 in the program's place
        rgb_p, depth_p = views["fp8"] if lower == "fp8" else \
            state.outputs[int(i)]
        d = np.abs(rgb_p.astype(np.int32) - rgb_r.astype(np.int32))
        dd = np.abs(depth_p.astype(np.int32) - depth_r.astype(np.int32))
        for k in SHARES:
            off[k] += int((d >= k).sum())
        fp8_off += int((np.abs(views["fp8"][0].astype(np.int32)
                               - rgb_r.astype(np.int32)) >= 2).sum())
        total += d.size
        for k, v in (("rgb_mean_gap", d.mean()), ("depth_mean_gap", dd.mean()),
                     ("rgb_p99_gap", np.percentile(d, 99))):
            worst[k] = max(worst.get(k, 0.0), float(v))
    shares = {f"rgb_share_off_{k}": off[k] / total for k in SHARES}
    return dict(shares, **worst, checked_requests=float(n),
                fp8_share_off_2=fp8_off / total,
                rgb_off_2_over_fp8=off[2] / max(fp8_off, FLOOR * total))


# uint8 levels by which a pixel's channel is off
SHARES = (2, 3, 4)
# the least share of the fp8 reference's channels off by 2 levels that
# `rgb_off_2_over_fp8` divides by: content that fp8 hardly moves
FLOOR = 0.01


def plant_faults(faults) -> None:
    """Faults the harness's tests plant in the timed path."""
    from tcnerf_torch.models import inference
    for fault in ("answer_altered", "half_batch"):
        if fault in faults:
            harness.plant(inference, "render_view", fault,
                          lambda render, fault=fault: broken(render, fault))


def broken(render, fault):
    def view(*a, **k):
        rgb, depth = render(*a, **k)
        rgb, depth = rgb.copy(), depth.copy()
        if fault == "answer_altered":
            rgb[: rgb.shape[0] // 8] = 255 - rgb[: rgb.shape[0] // 8]
        else:                       # the rays of half the image left out
            rgb[rgb.shape[0] // 2:] = 0
            depth[depth.shape[0] // 2:] = 0
        return rgb, depth
    return view
