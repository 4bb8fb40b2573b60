"""Time the chain kernels at the serving path's shapes, for A/B runs of
kernel variants.

    python3 -m tcnerf_torch.tools.bench_chain [--tag NAME]

K1 (`resmlp_rows`, the `_pallas_chain` half: 1,048,576 x 128 bf16 rows, f32
stream) over 0, 1, 2, 3 and 6 residual blocks; K2 (`swg_field_rows`, head
inside, 1,048,576 queries on a 480x640x128 image) over the same blocks with
uniform random coords and, at 0 and 6 blocks, with the coords sorted in
raster order (a real chunk's queries are coherent); K3 (head given, f32
stream) at 6 blocks. Each line gives ms per launch (CUDA events over 20
launches) and max |kernel - plain| / max |plain|. Weights are packed once,
as the serving paths do. To A/B two versions, copy `tcnerf_torch/` of each
into its own directory and run the tool in each, in the order A B B A,
one after another on one card.
"""

from __future__ import annotations

import torch

from ..ops.resmlp import pack_chain, resmlp_plain, resmlp_rows
from ..ops.swg import encode_head, pack_swg, swg_field_plain, swg_field_rows
from .common import base_parser, device_line, random_chain, time_ms

H, W, HID, N = 480, 640, 128, 1048576


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def main(argv=None) -> int:
    p = base_parser(__doc__)
    p.add_argument("--tag", default="", help="label printed on each line")
    args = p.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type != "cuda":
        raise SystemExit("bench_chain times the CUDA kernels: needs a card")
    print(device_line(dev), flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def line(name, fn, plain):
        err = rel_err(fn(), plain())
        print(f"{args.tag} {name}: {time_ms(fn, dev, 20):.4f} ms "
              f"(rel err {err:.3g})", flush=True)

    x = torch.randn((N, HID), generator=gen, device=dev).to(torch.bfloat16)
    for nb in (0, 1, 2, 3, 6):
        w = random_chain(gen, nb, None, 0, dev)
        pk = pack_chain(w, nb, skip_input=True, device=dev)
        line(f"K1 n_blocks={nb}",
             lambda: resmlp_rows(x, w, nb, skip_input=True, pack=pk),
             lambda: resmlp_plain(x, w, nb, skip_input=True))
    del x

    img = torch.randn((H, W, HID), generator=gen, device=dev).to(torch.bfloat16)
    coords = torch.stack([torch.rand(N, generator=gen, device=dev) * (W - 1),
                          torch.rand(N, generator=gen, device=dev) * (H - 1)],
                         -1).contiguous()
    raster = coords[torch.argsort(coords[:, 1].floor() * W + coords[:, 0])
                    ].contiguous()
    pos = (torch.randn((N, 3), generator=gen, device=dev) * 0.5).contiguous()
    dirs = (torch.randn((N, 3), generator=gen, device=dev) * 0.5).contiguous()
    hk = torch.randn((120, HID), generator=gen, device=dev) * 0.09
    hb = torch.randn((HID,), generator=gen, device=dev) * 0.1
    for nb in (0, 1, 2, 3, 6):
        w = random_chain(gen, nb, None, 4, dev)
        pk = pack_swg(w, nb, hk, hb)
        for name, c in (("random", coords), ("raster", raster)):
            if name == "raster" and nb not in (0, 6):
                continue
            a = (img, c, pos, dirs, w, nb, hk, hb)
            line(f"K2 n_blocks={nb} {name} coords",
                 lambda: swg_field_rows(*a, pack=pk),
                 lambda: swg_field_plain(*a))
    h0 = encode_head(pos, dirs, hk, hb, torch.bfloat16)
    kw = dict(h0_geo=h0, fast=False)
    line("K3 n_blocks=6 random coords",
         lambda: swg_field_rows(img, coords, None, None, w, 6, pack=pk, **kw),
         lambda: swg_field_plain(img, coords, None, None, w, 6, **kw))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
