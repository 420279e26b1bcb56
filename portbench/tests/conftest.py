"""Shared set-up of the benchmark's CPU tests.

``tiny_root`` builds a checkout-shaped directory with a copy of the
benchmark's folder whose cells are the real ones cut to a size the CPU
runs in seconds: the same entries, references, metrics and limits, with
only the sizes of the worlds, the model and the episodes changed.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the real cells and the tiny stand-in each test runs on the CPU
TINY = {"cnn-fleet-k100-batched": "cnn-tiny",
        "lm-fl-qwen05b-s512": "lm-tiny",
        "cnn-k100-beta-grid-w15": "grid-tiny"}
TINY_WORLD = {"K": 8, "rounds": 12, "l_iters": 2, "n_train": 600,
              "n_test": 120, "scale": 0.01, "max_per_vehicle": 64}
TINY_LM = {"hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 4, "vocab_size": 512}


def load(path: Path) -> dict:
    return json.loads(path.read_text())


def dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1))


def build_tiny_root(dst: Path) -> Path:
    """``dst`` with BENCHMARK.json and portbench/ whose cells are tiny."""
    shutil.copytree(BENCH, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = load(ROOT / "BENCHMARK.json")
    pb = dst / "portbench"
    cfg = load(pb / "configs" / "qwen1.5-0.5b.json")
    cfg.update(name="qwen-tiny", **TINY_LM)
    dump(cfg, pb / "configs" / "qwen-tiny.json")
    bench["configs"].append({"name": "qwen-tiny", "source": "tiny",
                             "file": "portbench/configs/qwen-tiny.json",
                             "reduced": [], "why": "CPU tests"})
    cells = []
    for w in bench["workloads"]:
        t = load(pb / "traffic" / f"{w['traffic']}.json")
        if t["entry"] == "lm_train":
            t.update(rounds=3, l_iters=2, batch=2, seq_len=16)
            config = "qwen-tiny"
        else:
            t["world"].update(TINY_WORLD)
            t["eval_every"] = 4
            config = w["config"]
            if t["entry"] == "sweep":
                t.update(seeds_per_grid=2, betas=[0.3, 0.7])
        name = TINY[w["name"]]
        dump(t, pb / "traffic" / f"{name}.json")
        cells.append({"name": name, "config": config, "traffic": name,
                      "chips": 1, "why": "CPU tests"})
    bench["workloads"] = cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY[w] for w in m["workloads"]]
    dump(bench, dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return build_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_tiny(root: Path, name: str, seed: int = 3, trace: bool = False,
              seconds: float = 0.0) -> dict:
    import time

    import torch

    from portbench.harness.cell import run_cell
    return run_cell(name, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), root)


@pytest.fixture
def run_tiny(tiny_root, one_thread):
    """``run_tiny(name, seed=3, trace=False, seconds=0)``: one run of a
    tiny cell on the CPU, past the harness's look for a card (``seconds``
    0: one episode), as the result's line."""
    return lambda name, **kw: _run_tiny(tiny_root, name, **kw)
