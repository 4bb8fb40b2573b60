"""A run's last line, at a size the CPU holds: its keys and their order,
the metrics by trace mode, and each compared number with its limit."""

import pytest

from benchmark.tests import tiny


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    line, err = tiny.emitted(tiny.run("nerf_1_view_wo.view", trace=trace))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = set(line["metrics"])
    if trace:
        assert "breakdown" in line
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "view.median_ms" in names and "setup_s" not in names
    else:
        assert names == {"view_ms_p95", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["checks"], "a cell compares at least one number"
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name}: " in err
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)
