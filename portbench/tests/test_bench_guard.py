"""Nothing the benchmark runs loads JAX or the JAX package, judged by the
top-level name of each module compared whole (the port, ``repro_torch``,
passes), and nothing opens a file of the JAX package or of its benchmark
folder."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import guard

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from portbench.harness import guard
watch = guard.OpenWatch({root!r})
import torch
torch.set_num_threads(1)
from pathlib import Path
from portbench.harness import spec
from portbench.harness.cell import run_cell
tiny = Path({tiny!r})
for name in ("cnn-tiny", "grid-tiny", "lm-tiny"):
    cell = spec.load_cell(name, tiny)
    spec.reference(cell, tiny)
    run_cell(name, 1, 0.0, False, torch.device("cpu"), time.perf_counter(),
             tiny)
import runpy
sys.argv = ["run.py", "--workload", "cnn-fleet-k100-batched", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
try:
    runpy.run_path({run!r}, run_name="__main__")
except SystemExit:
    pass
print(json.dumps({{"modules": guard.forbidden_modules(),
                  "opened": watch.hits}}))
"""


def test_forbidden_names_compare_whole():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
            "repro": 1, "repro.core": 1, "repro_torch": 1,
            "repro_torch.core": 1, "jaxtyping": 1, "reprox": 1}
    assert guard.forbidden_modules(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "repro", "repro.core"]


def test_runs_load_no_jax_and_read_no_jax_package(tiny_root):
    src = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"),
                        tiny=str(tiny_root),
                        run=str(ROOT / "portbench" / "run.py"))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"modules": [], "opened": []}


STUB_METRIC = '''def read(run):
    import repro  # noqa: F401
    return None
'''

STUB_REFERENCE = '''from portbench.harness.spec import load_module

_base = load_module("reference", "paper-cnn")
compare = _base.compare


def run_world(*args, **kwargs):
    import repro  # noqa: F401
    return _base.run_world(*args, **kwargs)
'''


def _plant_metric(root):
    (root / "portbench/metrics/stub.loads_repro.py").write_text(STUB_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(
        {"name": "stub.loads_repro", "unit": "%", "better": "higher",
         "source": "program_counter", "layer": "entry",
         "moves": "world_rounds_per_s", "workloads": ["cnn-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "cnn-tiny", True


def _plant_reference(root):
    (root / "portbench/reference/stub-cnn.py").write_text(STUB_REFERENCE)
    cfg = json.loads((root / "portbench/configs/paper-cnn.json").read_text())
    cfg.update(name="stub-cnn", reference="stub-cnn")
    (root / "portbench/configs/stub-cnn.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub-cnn", "source": "x",
                             "file": "portbench/configs/stub-cnn.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "stub-cell", "config": "stub-cnn",
                               "traffic": "cnn-tiny", "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "stub-cell", False


@pytest.mark.parametrize("plant", [_plant_metric, _plant_reference],
                         ids=["metric_reader", "reference"])
def test_run_that_loads_the_jax_package_after_the_window_refuses(
        tiny_root, one_thread, tmp_path, monkeypatch, plant):
    """A per-layer reader, or the reference, that imports a module named
    ``repro`` once the window has closed leaves the run with no result."""
    import shutil
    import time

    import torch

    from portbench.harness.cell import run_cell
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    stub = tmp_path / "stub"
    (stub / "repro").mkdir(parents=True)
    (stub / "repro" / "__init__.py").write_text("")
    name, trace = plant(root)
    monkeypatch.syspath_prepend(str(stub))
    prev = sys.modules.pop("repro", None)
    try:
        with pytest.raises(SystemExit, match="repro"):
            run_cell(name, 2, 0.0, trace, torch.device("cpu"),
                     time.perf_counter(), root)
        assert "repro" in sys.modules
    finally:
        sys.modules.pop("repro", None)
        if prev is not None:
            sys.modules["repro"] = prev
