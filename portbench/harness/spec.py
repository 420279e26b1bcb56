"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each lives in a file of its
own (``configs/<config>.json``, ``traffic/<traffic>.json``), the mix names
the entry that drives it (``entries/<entry>.py``), the configuration the
plain reference of its architecture (``reference/<reference>.py``, by the
file's ``"reference"`` key, so configurations of one family share one), and
each per-layer metric has a reader of its own (``metrics/<metric>.py``).  A
new cell, mix, configuration, reference or metric is new files and new
entries in ``BENCHMARK.json``: nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the metric entries this cell reports
    per_layer: list


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench_dir = root / BENCH_DIR.name
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def load_module(kind: str, name: str, root: Path = ROOT):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
    (names may hold dots and dashes)."""
    path = root / BENCH_DIR.name / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(cell: Cell, root: Path = ROOT):
    return load_module("entries", cell.traffic["entry"], root)


def reference(cell: Cell, root: Path = ROOT):
    return load_module("reference", cell.config["reference"], root)


def metric_reader(name: str, root: Path = ROOT):
    return load_module("metrics", name, root)
