"""`lib/program.py` reads the port's own spans and counters: the window's
roots by position, nothing on too few roots or dropped spans; and every
metric that reads them, on a tiny traced run of each cell on the CPU."""

import math
from types import SimpleNamespace

import pytest

from benchmark.lib import program, registry
from benchmark.tests import tiny
from tcnerf_torch.utils import profiling

# the metrics that read the program's spans and counters, by cell; those
# from the device's trace read nothing on the CPU
PROGRAM = {
    "goal_1_view.infer": ["grasp.guesses_ms", "grasp.topk_ms",
                          "setup.init_params_s"],
    "nerf_1_view_wo.train": ["train.enqueue_ms", "train.feed_wait_ms",
                             "train.feed_make_ms", "setup.init_params_s"],
    "nerf_1_view_wo.view": ["view.chunks_enqueue_ms", "view.readback_ms",
                            "view.k2_launches", "setup.init_params_s",
                            "setup.kernels_build_s"],
}
DEVICE = {
    "goal_1_view.infer": ["grasp.encode_dev_ms", "grasp.prepare_dev_ms",
                          "grasp.step_dev_ms"],
    "nerf_1_view_wo.train": ["train.forward_dev_ms", "train.backward_dev_ms",
                             "train.update_dev_ms"],
    "nerf_1_view_wo.view": [],
}


def span(name, sid, start, end, parent=None, root=None, counters=None):
    return profiling.Span(name, sid, parent, sid if root is None else root,
                          1, start, end, counters)


def fake_snapshot(monkeypatch, spans, dropped=0):
    counters = {"spans.dropped": dropped} if dropped else {}
    monkeypatch.setattr(program, "_snapshot",
                        lambda: profiling.Snapshot(spans, counters))


def run(records, trace_units=2, traced=True, warmup=1):
    return SimpleNamespace(
        traffic={"driver": "view", "trace_units": trace_units,
                 "warmup_units": warmup},
        records=[{}] * records, trace=object() if traced else None)


def views(n):
    """n views of 10 ns, each with one chunk span and 76 launches; a
    set-up span before them, and a kernel build inside the first view."""
    spans = [span("tcnerf.init_params", 1000, 0, 5),
             span("tcnerf.kernels.build", 1001, 103, 107, parent=12,
                  root=10)]
    for i in range(n):
        sid, t = 10 * (i + 1), 100 * (i + 1)
        spans += [span("tcnerf.chunks", sid + 1, t + 2, t + 2 + i,
                       parent=sid, root=sid),
                  span("tcnerf.view", sid, t, t + 10,
                       counters={"kernels.swg.swg_head_inside": 76,
                                 "kernels.resmlp.resmlp_launch": i})]
    return spans


def test_window_roots_by_position(monkeypatch):
    fake_snapshot(monkeypatch, views(6))
    # 1 warm-up, 3 in the window, 2 traced: the window is views 2-4
    win = program.window(run(3))
    assert [r.id for r in win.roots] == [20, 30, 40]
    assert win.per_root_ms("tcnerf.chunks") == pytest.approx(
        [1e-6, 2e-6, 3e-6])
    assert win.each_ms("tcnerf.view") == pytest.approx([1e-5] * 3)
    assert win.counter_changes("kernels.swg.") == [76, 76, 76]
    # untraced: the window is the last roots
    assert [r.id for r in program.window(run(3, traced=False)).roots] == [
        40, 50, 60]
    # set-up: before the window's first root, its warm-up view included
    assert program.in_setup_s(run(3), "tcnerf.init_params") == \
        pytest.approx(5e-9)
    assert program.in_setup_s(run(3), "tcnerf.kernels.build") == \
        pytest.approx(4e-9)
    # without a warm-up the first view is an earlier run's: what it and
    # the spans before it took is not this run's set-up
    assert program.in_setup_s(run(3, warmup=0), "tcnerf.kernels.build") == 0
    assert program.in_setup_s(run(3, warmup=0), "tcnerf.init_params") == 0


def test_nothing_on_too_few_roots_or_dropped_spans(monkeypatch):
    fake_snapshot(monkeypatch, views(4))
    assert program.window(run(3)) is None
    assert program.in_setup_s(run(3), "tcnerf.init_params") is None
    assert program.window(run(2)) is not None
    fake_snapshot(monkeypatch, views(6), dropped=1)
    assert program.window(run(3)) is None
    assert program.in_setup_s(run(3), "tcnerf.init_params") is None
    monkeypatch.setattr(program, "_snapshot", lambda: None)   # older port
    assert program.window(run(3)) is None
    assert program.in_setup_s(run(3), "tcnerf.kernels.build") is None


@pytest.mark.parametrize("name", tiny.CELLS)
def test_new_metrics_read_on_a_tiny_traced_run(name, monkeypatch):
    tiny.keep_fault_targets(monkeypatch)
    profiling.reset()
    result = tiny.run(name, trace=True)
    cell = registry.find_cell(name)
    listed = {m.name for m in cell.per_layer}
    assert set(PROGRAM[name]) | set(DEVICE[name]) <= listed
    for metric in PROGRAM[name]:
        value = result.metrics[metric]["value"]
        assert math.isfinite(value) and value >= 0, metric
    for metric in DEVICE[name]:           # no device in a CPU trace
        assert metric not in result.metrics
    if name == "nerf_1_view_wo.view":     # the plain path launches no K2
        assert result.metrics["view.k2_launches"]["value"] == 0
        assert result.metrics["setup.kernels_build_s"]["value"] == 0
