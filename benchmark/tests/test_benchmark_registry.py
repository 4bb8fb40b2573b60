"""The registry finds every cell, configuration, traffic mix, cell file and
metric by the names in BENCHMARK.json, fails loudly on a missing one, and picks up a
new cell and a new metric added as files and entries alone."""

import json
import shutil

import pytest

from benchmark.lib import registry

BENCH = registry.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = registry.find_cell(name)
    assert cell.config["name"] == cell.spec["config"]
    assert hasattr(cell.driver(), "setup")
    names = [m.name for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read)


def test_every_metric_has_a_reader():
    for spec in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.load_metric(spec).reader.read)


def copy_tree(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_missing_names_fail_loudly(tmp_path):
    root = copy_tree(tmp_path)
    with pytest.raises(registry.RegistryError, match="no workload"):
        registry.find_cell("no_such.cell", root=root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "grasp_closed.json").unlink()
    with pytest.raises(registry.RegistryError, match="does not exist"):
        registry.find_cell("goal_1_view.infer", bench, root)
    (root / "benchmark" / "cells" / "nerf_1_view_wo.train.json").unlink()
    with pytest.raises(registry.RegistryError, match="does not exist"):
        registry.find_cell("nerf_1_view_wo.train", bench, root)
    bench["per_layer"].append({"name": "no_reader", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "view_ms_p95",
                               "workloads": ["nerf_1_view_wo.view"]})
    with pytest.raises(registry.RegistryError, match="does not exist"):
        registry.find_cell("nerf_1_view_wo.view", bench, root)


def test_new_cell_and_metric_from_files_alone(tmp_path):
    root = copy_tree(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((root / "benchmark" / "traffic" /
                          "views_closed.json").read_text())
    traffic["check_requests"] = 1
    (root / "benchmark" / "traffic" / "views_single_check.json").write_text(
        json.dumps(traffic))
    (root / "benchmark" / "cells" / "nerf_1_view_wo.view1.json").write_text(
        json.dumps({"limits": {"rgb_share_off_3": 0.02},
                    "control": {"reference_lower": "fp8"}}))
    (root / "benchmark" / "metrics" / "view.max_ms.py").write_text(
        "def read(run):\n"
        "    return max(r['latency_s'] for r in run.records) * 1e3\n")
    bench["workloads"].append({"name": "nerf_1_view_wo.view1",
                               "config": "nerf_1_view_wo",
                               "traffic": "views_single_check", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "view.max_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "view entry", "moves": "view_ms_p95",
                               "workloads": ["nerf_1_view_wo.view1"]})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index(
        "view_ms_p95")]["workloads"].append("nerf_1_view_wo.view1")
    cell = registry.find_cell("nerf_1_view_wo.view1", bench, root)
    assert cell.traffic["check_requests"] == 1
    assert cell.checks["limits"] == {"rgb_share_off_3": 0.02}
    assert [m.name for m in cell.per_layer] == ["view.max_ms"]
    run = type("Run", (), {"records": [{"latency_s": 0.25}]})()
    assert cell.per_layer[0].read(run) == 250.0
    assert set(registry.all_cells(bench, root)) >= {
        "nerf_1_view_wo.view1", "goal_1_view.infer"}
