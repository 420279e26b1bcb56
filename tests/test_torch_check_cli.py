"""``python -m repro_torch.check``: the rule list, ``repro``'s JSON keys,
the ``--strict`` exit codes (1 on the leaky fixture, 0 on the port's own
tree with every probe), the fixture corpus left out of default scans, and
an analyzer that raises failing the run."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.check.runner import main as jmain
from repro_torch.check import findings, plan_shapes
from repro_torch.check.runner import collect_files, main
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src/repro_torch"


def test_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rid in out for rid in findings.RULES)
    assert "TEL001" in out and "BND005" not in out


def test_json_keys_equal_repro(capsys):
    assert jmain(["src/repro/check/findings.py", "--no-probes",
                  "--format=json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert main([str(PORT / "check/findings.py"), "--no-probes",
                 "--format=json"]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert set(mine) == set(ref) == {"kernels", "findings", "timings_s"}
    assert set(mine["kernels"][0]) == set(ref["kernels"][0])
    assert mine["findings"] == []
    assert {k["classification"] for k in mine["kernels"]} == {
        "parallel-safe"}


def test_strict_exits_1_on_the_leaky_fixture(tmp_path, capsys):
    leaky = tmp_path / "leaky.py"
    leaky.write_text((PORT / "check/corpus/leaky_engine.py").read_text())
    assert main([str(leaky), "--no-probes", "--strict"]) == 1
    out = capsys.readouterr().out
    assert all(r in out for r in ("BND001", "BND002", "BND003", "BND004"))
    assert main([str(leaky), "--no-probes"]) == 0


def test_strict_exits_0_on_the_port_with_probes():
    """``python -m repro_torch.check src/repro_torch --strict`` as a user
    runs it from the repo root, in a process that never imports jax or
    repro."""
    code = ("import json, runpy, sys\n"
            "sys.argv = ['repro_torch.check', 'src/repro_torch', "
            "'--strict', '--format=json']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.check', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
            "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    report, _, last = out.stdout.rstrip().rpartition("\n")
    assert json.loads(last) == {"rc": 0, "bad": []}, out.stdout[-2000:]
    payload = json.loads(report)
    assert not [f for f in payload["findings"] if not f["waived"]]
    assert set(payload["timings_s"]) == {"boundary", "grid_race",
                                         "plan_shapes", "dtype_flow",
                                         "telemetry_off"}


def test_fixture_corpus_is_excluded_from_default_scans():
    files = collect_files([str(PORT)])
    assert files, "scan set must not be empty"
    assert not any("check/corpus" in f.as_posix() for f in files)
    assert collect_files([str(PORT / "check/corpus/racy_kernel.py")]) == []


def test_an_analyzer_that_raises_fails_the_run(monkeypatch):
    def broken():
        raise RuntimeError("probe broke")
    monkeypatch.setattr(plan_shapes, "probe_plan_shapes", broken)
    with pytest.raises(RuntimeError, match="probe broke"):
        main([str(PORT / "check/findings.py")])
