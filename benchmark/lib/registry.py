"""Finds a cell's parts by the names in `BENCHMARK.json`.

    configs/<file named by the configuration>   sizes, source, port overrides
    traffic/<traffic>.json                      driver name and parameters
    cells/<cell>.json                           the cell's limits, control
                                                and host settings
    drivers/<driver>.py                         set-up and unit of work
    metrics/<metric>.py                         one metric's reader

A later change adds a cell, a configuration, a traffic mix or a metric by
adding such files and entries. A name that has no file fails loudly.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]             # the checkout


class RegistryError(LookupError):
    pass


def _load_module(path: Path, prefix: str, root: Path = ROOT) -> ModuleType:
    if not path.is_file():
        raise RegistryError(f"{path.relative_to(root)} does not exist")
    name = f"_bench_{prefix}_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Metric:
    spec: dict                     # the entry of BENCHMARK.json
    reader: ModuleType

    @property
    def name(self) -> str:
        return self.spec["name"]

    def read(self, run) -> Optional[float]:
        return self.reader.read(run)


@dataclass
class Cell:
    spec: dict                     # the workloads entry
    config: dict                   # configs/<file>
    traffic: dict                  # traffic/<traffic>.json
    checks: dict                   # cells/<cell>.json
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path = ROOT

    @property
    def name(self) -> str:
        return self.spec["name"]

    def driver(self) -> ModuleType:
        return load_driver(self.traffic["driver"], self.root)


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise RegistryError(f"{path} does not exist")
    return json.loads(path.read_text())


def load_driver(name: str, root: Path = ROOT) -> ModuleType:
    return _load_module(root / "benchmark" / "drivers" / f"{name}.py",
                        "driver", root)


def load_metric(spec: dict, root: Path = ROOT) -> Metric:
    return Metric(spec, _load_module(
        root / "benchmark" / "metrics" / f"{spec['name']}.py", "metric",
        root))


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Whether `metric` is read in `cell`: listed there, or, without a
    `workloads` key, wherever the end-to-end metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell_file(name: str, root: Path = ROOT) -> dict:
    """`cells/<cell>.json`: `limits` ({number: limit}, set from the
    readings of this cell alone), `control` (the driver's parameters that
    put the reference in the nearest lower precision in the program's
    place) and optionally `host_cores` (the run is pinned to that many of
    the host's cores)."""
    path = root / "benchmark" / "cells" / f"{name}.json"
    if not path.is_file():
        raise RegistryError(f"{path.relative_to(root)} does not exist")
    checks = json.loads(path.read_text())
    for key in ("limits", "control"):
        if not isinstance(checks.get(key), dict):
            raise RegistryError(f"{path.relative_to(root)} has no {key!r}")
    if not checks["limits"]:
        raise RegistryError(f"{path.relative_to(root)} compares nothing")
    return checks


def find_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise RegistryError(f"no workload {name!r} in BENCHMARK.json "
                            f"(have {sorted(specs)})")
    spec = specs[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if spec["config"] not in configs:
        raise RegistryError(f"workload {name}: no configuration "
                            f"{spec['config']!r}")
    cfg_path = root / configs[spec["config"]]["file"]
    if not cfg_path.is_file():
        raise RegistryError(f"{cfg_path.relative_to(root)} does not exist")
    config = json.loads(cfg_path.read_text())
    config.setdefault("name", spec["config"])
    traffic_path = root / "benchmark" / "traffic" / f"{spec['traffic']}.json"
    if not traffic_path.is_file():
        raise RegistryError(
            f"{traffic_path.relative_to(root)} does not exist")
    traffic = json.loads(traffic_path.read_text())
    checks = load_cell_file(name, root)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, name, reported)]
    return Cell(spec, config, traffic, checks,
                [load_metric(m, root) for m in e2e],
                [load_metric(m, root) for m in per_layer], root)


def all_cells(bench: Optional[dict] = None,
              root: Path = ROOT) -> Dict[str, Cell]:
    bench = load_benchmark(root) if bench is None else bench
    return {w["name"]: find_cell(w["name"], bench, root)
            for w in bench["workloads"]}
