"""Every cell, configuration, mix and metric of ``BENCHMARK.json`` loads from
its own files, and the file keeps the benchmark contract's shape."""
from __future__ import annotations

import json
import re

from pathlib import Path

import pytest

from portbench.harness import spec, yardstick

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E = {"world_rounds_per_s", "trained_tokens_per_s", "setup_s"}
PER_LAYER = {"entry.overhead_share", "batched.run_ms_per_round",
             "sweep.run_ms_per_round", "cnn.mfu", "k2_roofline.sim",
             "k2.launches_per_round.sim", "k1_roofline",
             "device.idle_share.sim", "lm.mfu", "k3_roofline",
             "k2_roofline.lm", "device.idle_share.lm"}


def test_top_level_keys_and_command():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in BENCHMARK[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_sets():
    assert {m["name"] for m in BENCHMARK["end_to_end"]} == E2E
    assert {m["name"] for m in BENCHMARK["per_layer"]} == PER_LAYER


@pytest.mark.parametrize("m", BENCHMARK["end_to_end"] + BENCHMARK["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry_shape(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    if m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        allowed = {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}
        assert m["moves"] in E2E - {"setup_s"}
    assert set(m) <= allowed
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("m", BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(m):
    """Each cell a per-layer metric lists reports the end-to-end metric it
    moves, and its reader is a file of its own."""
    moved = next(e for e in BENCHMARK["end_to_end"] if e["name"] == m["moves"])
    for w in m["workloads"]:
        assert w in moved["workloads"]
    assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_cell_loads_from_its_files(w):
    cell = spec.load_cell(w["name"])
    assert w["chips"] == 1
    assert TEXT.match(w["why"])
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    ent = spec.entry(cell)
    ref = spec.reference(cell)
    for fn in ("setup", "episode", "select", "check", "control"):
        assert callable(getattr(ent, fn))
    assert callable(ref.compare)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert set(cell.traffic["limits"]) >= {"order"}
    for e2e in names - {"setup_s"}:
        assert e2e in ent.RATES


@pytest.mark.parametrize("c", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert c["file"].startswith("portbench/configs/")
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"]
    assert TEXT.match(c["source"]) and c["source"].startswith("https://")
    assert len(c["reduced"]) <= 16
    for k in c["reduced"]:
        assert NAME.match(k)
        assert not re.search(r"(hidden|intermediate|latent|state|_dim|"
                             r"_rank|head|expert)", k)
    assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()


def test_parameter_counts_match_the_configs():
    cnn = json.loads((BENCH / "configs" / "paper-cnn.json").read_text())
    qwen = json.loads((BENCH / "configs" / "qwen1.5-0.5b.json").read_text())
    assert yardstick.cnn_param_count(cnn) == cnn["params"]
    assert yardstick.lm_param_count(qwen) == qwen["params"] == 463_987_712


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_nan_reading_is_worst_and_over_its_limit():
    from portbench.harness.cell import checks_of, over, worst
    nan = float("nan")
    items = [{"order": 0, "loss": 1e-7}, {"order": 0, "loss": nan},
             {"order": 1, "loss": 2e-7}]
    w = worst(items)
    assert w["order"] == 1 and w["loss"] != w["loss"]
    limits = {"order": 0, "loss": 1e-5}
    assert [bool(over(n, limits)) for n in items] == [False, True, True]
    assert checks_of(w, limits)["loss"]["limit"] == 1e-5


def _cnn_world(losses, params=None):
    import torch
    p = params or {"w": torch.ones(4)}
    return {"events": [(0, 1.0)], "loss": list(enumerate(losses, 1)),
            "params": p, "init": {"w": torch.zeros(4)},
            "grad0": {"w": 1.0}}


def test_cnn_loss_is_the_median_over_every_compared_eval():
    """One world whose every eval sits apart (a tie broken early in a
    shared timeline) leaves the pooled median at its neighbours' gap;
    every world apart (lower precision everywhere) moves it."""
    ref = spec.load_module("reference", "paper-cnn")
    want = [1.0] * 6
    apart = [1.0 + 1e-4] * 6
    near = [1.0, 1.0, 1.0 + 1e-8, 1.0, 1.0, 1.0 + 1e-3]
    one = ref.compare([(_cnn_world(apart), _cnn_world(want)),
                       (_cnn_world(near), _cnn_world(want)),
                       (_cnn_world(near), _cnn_world(want))])
    assert one["order"] == 0 and one["loss"] < 1e-6
    every = ref.compare([(_cnn_world(apart), _cnn_world(want))] * 3)
    assert every["loss"] == pytest.approx(1e-4)


def test_cnn_change_is_the_worst_world():
    import torch
    ref = spec.load_module("reference", "paper-cnn")
    same = _cnn_world([1.0])
    still = _cnn_world([1.0], {"w": torch.zeros(4)})
    out = ref.compare([(same, _cnn_world([1.0])),
                       (still, _cnn_world([1.0]))])
    assert out["change"] == 1.0
