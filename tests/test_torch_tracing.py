"""The port's spans and counters (`tcnerf_torch/utils/profiling.py`) on the
CPU: the trees that a grasp request, a view and a fed train step record,
the profiler ranges they open only while a profiler records (and where),
the buffer's bound, and the CUDA libraries' launch counts read once.

Sizes are tiny: the grasp pipeline demo's (`models/pipeline.py` `_demo`:
64 guesses, 4 ascent steps), a 24x32 stage-1 renderer with a 32-wide ViT
and 4 samples a ray.
"""

import collections
import json
import threading

import numpy as np
import pytest
import torch

from tcnerf_torch.data import synthetic
from tcnerf_torch.data.prefetch import prefetch_to_device
from tcnerf_torch.models import inference, pipeline, training
from tcnerf_torch.models.renderer import MVNeRFRenderer
from tcnerf_torch.ops import cuda_lib, gather, resmlp, swg
from tcnerf_torch.params import init_params
from tcnerf_torch.utils import profiling

H, W = 24, 32
CFG = dict(n_views=1, n_samples=4, n_features=8, near=0.3, far=1.3,
           original_image_size=(H, W), fusion="without", n_blocks=2,
           hidden_size=32, vit_size=(32, 32), vit_dim=32, vit_heads=2,
           vit_hooks=(1, 2, 3, 4), corner_gather=False, remat=True)
GRASP_PARTS = ["tcnerf.grasp.encode", "tcnerf.grasp.prepare",
               "tcnerf.grasp.guesses", "tcnerf.grasp.energies",
               "tcnerf.grasp.topk"]
# the ranges that view.encode_ms and view.chunks_ms read: nothing new
# may open inside them, or their kernels would move to the new range
MEASURED = ("tcnerf.encode", "tcnerf.combine", "tcnerf.chunks")


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def renderer():
    m = MVNeRFRenderer(**CFG)
    init_params(m, torch.Generator().manual_seed(0))
    return m.eval()


def _view(model):
    src_cfg, tgt_cfg = synthetic.camera_ring(2, height=H, width=W,
                                             azimuth_span=0.6)
    src = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    return inference.render_view(model, [src], [src_cfg], tgt_cfg,
                                 generator=torch.Generator().manual_seed(1),
                                 chunk=256, device="cpu")


def _batches(n, b=1, r=16):
    rng = np.random.default_rng(2)
    k4 = np.eye(4, dtype=np.float32)
    k4[:3, :3] = [[30, 0, W / 2], [0, 30, H / 2], [0, 0, 1]]
    for _ in range(n):
        rd = rng.normal(size=(b, r, 3)).astype(np.float32)
        rd[..., 2] = np.abs(rd[..., 2]) + 1
        yield ((np.zeros((b, r, 3), np.float32), rd,
                rng.uniform(size=(b, 1, H, W, 3)).astype(np.float32),
                np.tile(k4, (b, 1, 1, 1)),
                np.tile(np.eye(4, dtype=np.float32), (b, 1, 1, 1))),
               rng.uniform(size=(b, r, 3)).astype(np.float32))


def _train(model, steps=2):
    state = training.create_train_state(model)
    gen = torch.Generator().manual_seed(3)
    for inputs, labels in prefetch_to_device(_batches(steps),
                                             torch.device("cpu")):
        state, _ = training.nerf_train_step(state, inputs, labels, gen,
                                            ray_chunk=8)


def _tree(spans, root):
    """The names under `root`, each with its count."""
    return collections.Counter(s.name for s in spans
                               if s.root == root.id and s.id != root.id)


def test_grasp_request_is_one_tree():
    result = pipeline._demo(device="cpu")
    spans = profiling.snapshot().spans
    roots = [s for s in spans if s.parent is None
             and s.name != "tcnerf.init_params"]
    assert [r.name for r in roots] == ["tcnerf.grasp"]
    root = roots[0]
    assert _tree(spans, root) == collections.Counter(
        GRASP_PARTS + ["tcnerf.grasp.step"] * 4)
    assert all(s.parent == root.id for s in spans if s.root == root.id
               and s.id != root.id)
    assert root.start_ns <= min(s.start_ns for s in spans
                                if s.root == root.id)
    # the result's duration is the root's: encode to top-k, on perf_counter
    assert result.duration_s == (root.end_ns - root.start_ns) * 1e-9


def test_view_and_fed_train_step_trees(renderer):
    _view(renderer)
    _train(renderer, steps=2)
    spans = profiling.snapshot().spans
    main = threading.get_ident()
    views = [s for s in spans if s.name == "tcnerf.view"]
    assert len(views) == 1 and views[0].parent is None
    assert _tree(spans, views[0]) == collections.Counter({
        "tcnerf.view.inputs": 1, "tcnerf.encode": 1, "tcnerf.combine": 1,
        "tcnerf.view.rays": 1, "tcnerf.chunks": 1,
        "tcnerf.view.assemble": 1, "tcnerf.view.readback": 1})
    steps = [s for s in spans if s.name == "tcnerf.train.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for step in steps:
        tree = [s for s in spans if s.root == step.id and s.id != step.id]
        by_name = {s.name: s for s in tree}
        assert sorted(by_name) == sorted([
            "tcnerf.train.forward", "tcnerf.encode", "tcnerf.combine",
            "tcnerf.train.backward", "tcnerf.train.update"])
        forward = by_name["tcnerf.train.forward"]
        assert by_name["tcnerf.encode"].parent == forward.id
        assert [s.name for s in tree if s.parent == step.id] == [
            "tcnerf.train.forward", "tcnerf.train.backward",
            "tcnerf.train.update"]
    waits = [s for s in spans if s.name == "tcnerf.feed.wait"]
    makes = [s for s in spans if s.name == "tcnerf.feed.make"]
    # two batches and the end of the feed, each waited for and made
    assert len(waits) == len(makes) == 3
    assert all(s.parent is None and s.thread == main for s in waits)
    assert all(s.parent is None and s.thread != main for s in makes)
    assert all(s.thread == main for s in spans
               if s.name != "tcnerf.feed.make")


def _ranges(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def test_spans_are_ranges_under_the_profiler(renderer, tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        pipeline._demo(device="cpu")
        _view(renderer)
        _train(renderer, steps=1)
    ranges = _ranges(prof.trace_path)
    names = {n for _, _, n in ranges}
    assert names >= {"tcnerf.grasp", "tcnerf.grasp.step", *GRASP_PARTS,
                     "tcnerf.view", "tcnerf.view.inputs", "tcnerf.view.rays",
                     "tcnerf.view.assemble", "tcnerf.view.readback",
                     "tcnerf.train.step",
                     "tcnerf.train.forward", "tcnerf.train.backward",
                     "tcnerf.train.update", "tcnerf.feed.wait",
                     *MEASURED}
    assert "tcnerf.feed.make" not in names
    # nothing of the port's opens inside the measured ranges
    for a, b, outer in ranges:
        if outer in MEASURED:
            inside = {n for x, y, n in ranges
                      if a <= x and y <= b and (x, y) != (a, b)
                      and n.startswith("tcnerf.")}
            assert not inside, (outer, inside)


def test_no_range_without_the_profiler(renderer, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Counting)
    pipeline._demo(device="cpu")
    _view(renderer)
    _train(renderer, steps=1)
    assert entered == []
    assert len(profiling.snapshot().spans) > 20
    # the same spans do enter it while a profiler records
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("tcnerf.view"):
            with profiling.span("tcnerf.feed.make", profile=False):
                pass
    assert entered == ["tcnerf.view"]


def test_buffer_bound_raises_dropped(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, "capacity", 3)
    for _ in range(5):
        with profiling.span("a"):
            pass
    snap = profiling.snapshot()
    assert len(snap.spans) == 3 and snap.counters["spans.dropped"] == 2
    profiling.reset()
    snap = profiling.snapshot()
    assert snap.spans == [] and "spans.dropped" not in snap.counters


def test_kernel_counts_are_read_not_kept_twice():
    """A launch raises its library's count once (`KernelLib.counts`); the
    recorder reads that count, and a root span its change."""
    libs = {"kernels.swg": swg.SWG, "kernels.resmlp": resmlp.RESMLP,
            "kernels.gather": gather.GATHER}
    sources = [p for p, _ in profiling.RECORDER._sources]
    assert all(sources.count(p) == 1 for p in libs)
    counts = swg.SWG.counts
    before = counts["swg_head_inside"]
    try:
        with profiling.span("tcnerf.view") as root:
            counts["swg_head_inside"] += 76
        snap = profiling.snapshot()
        assert snap.counters["kernels.swg.swg_head_inside"] == before + 76
        assert snap.spans[-1].id == root.id
        assert snap.spans[-1].counters == {"kernels.swg.swg_head_inside": 76}
    finally:
        counts["swg_head_inside"] -= 76
    assert profiling.snapshot().counters[
        "kernels.swg.swg_head_inside"] == before
    for prefix, lib in libs.items():
        got = {k[len(prefix) + 1:]: v
               for k, v in profiling.snapshot().counters.items()
               if k.startswith(prefix + ".")}
        assert got == {k: v for k, v in lib.counts.items()}


def test_root_counters_only_in_the_launching_thread():
    """The counters are the process's: a root opened with profile=False
    (the feed's producer thread) keeps none, so it cannot take another
    thread's launches for its own."""
    counts = swg.SWG.counts
    try:
        with profiling.span("tcnerf.feed.make", profile=False):
            counts["swg_head_inside"] += 1
        with profiling.span("tcnerf.view"):
            with profiling.span("tcnerf.chunks"):
                counts["swg_head_inside"] += 2
    finally:
        counts["swg_head_inside"] -= 3
    spans = {s.name: s for s in profiling.snapshot().spans}
    assert spans["tcnerf.feed.make"].counters is None
    assert spans["tcnerf.chunks"].counters is None
    assert spans["tcnerf.view"].counters == {"kernels.swg.swg_head_inside": 2}


def test_kernel_build_is_a_span_but_never_a_range(tmp_path):
    """`build_all` runs under "tcnerf.kernels.build" (read by the
    benchmark's setup.kernels_build_s); a first launch builds lazily, inside
    "tcnerf.chunks", so it never opens a profiler range."""
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("tcnerf.chunks"):
            assert cuda_lib.build_all([]) == {}
    build = profiling.snapshot().spans[0]
    assert build.name == "tcnerf.kernels.build" and build.parent is not None
    assert {n for _, _, n in _ranges(prof.trace_path)} == {"tcnerf.chunks"}


def test_shared_render_helpers_record_no_spans():
    """The sharded render (`parallel/serve.py`) calls `_ray_chunks` and
    `_assemble` outside any view: they open no span of their own."""
    pose = torch.eye(4)
    intr = torch.tensor([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
    o, d, n = inference._ray_chunks(pose, intr, H, W, 256)
    inference._assemble([o.reshape(-1, 3)], [d.reshape(-1, 3)[:, 0]], n,
                        H, W)
    assert profiling.snapshot().spans == []
