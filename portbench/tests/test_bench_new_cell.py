"""A cell added as new files and a new ``BENCHMARK.json`` entry runs with
no edit to a file the benchmark already has."""
from __future__ import annotations

import hashlib
import json
import time

import torch

from portbench.harness.cell import run_cell


def _digest(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_cell_from_new_files_only(tiny_root, one_thread, tmp_path):
    import shutil
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    before = _digest(root)
    # a new mix of an existing entry and a new configuration of the same
    # architecture, which names the reference it shares: files and
    # entries only
    mix = json.loads((root / "portbench/traffic/cnn-tiny.json").read_text())
    mix["world"].update(K=6, rounds=8)
    mix["use_kernel"] = False
    (root / "portbench/traffic/new-mix.json").write_text(json.dumps(mix))
    cfg = json.loads((root / "portbench/configs/paper-cnn.json").read_text())
    cfg["name"] = "paper-cnn-copy"
    (root / "portbench/configs/paper-cnn-copy.json").write_text(
        json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "paper-cnn-copy", "source": "x",
                             "file": "portbench/configs/paper-cnn-copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "paper-cnn-copy",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cnn-tiny" in m.get("workloads", ()):
            m["workloads"].append("new-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = run_cell("new-cell", 4, 0.0, False, torch.device("cpu"),
                   time.perf_counter(), root)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"world_rounds_per_s", "setup_s"}
    traced = run_cell("new-cell", 4, 0.0, True, torch.device("cpu"),
                      time.perf_counter(), root)
    assert "entry.overhead_share" in traced["metrics"]
    after = _digest(root)
    assert {k: after[k] for k in before} == before
