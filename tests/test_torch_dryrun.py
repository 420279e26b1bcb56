"""The port's dry run (``python -m repro_torch.launch.dryrun``) and its
numerics fingerprint (``repro_torch.core.codegen``).

- ``arch_for`` gives ``repro``'s config (every field) for every arch and
  shape, the train overrides and the padded vocab included.
- The CLI, in a subprocess on a fake process group of 256 ranks, cut to 2
  layers (``--override n_layers=2``): a record for each of two archs, with
  ``repro``'s record keys (``trace_seconds`` in place of
  ``compile_seconds`` and ``while_trips``), counts that are positive and
  finite, and no failure.
- Carrying the counts of 1 and 2 periods to the whole depth equals
  counting every period (3 periods of a cut smollm-360m decode step).
- ``codegen_fingerprint`` is deterministic and has ``repro``'s keys."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as jget, legal_shapes, list_archs
from repro.launch import dryrun as jdry
from repro_torch.launch import dryrun as tdry
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
# repro's record keys (lower_one's), less its two compile-time keys
REPRO_KEYS = {
    "arch", "shape", "mesh", "flops_per_device", "hbm_bytes_per_device",
    "collective_bytes_per_device", "compute_s", "memory_s", "collective_s",
    "bottleneck", "model_flops", "useful_flops_ratio",
    "memory_per_device_bytes", "fits_hbm", "collective_breakdown",
    "raw_cost_analysis_flops", "n_chips", "param_count",
    "param_count_active", "argument_bytes", "output_bytes", "temp_bytes"}


def test_arch_for_equals_repro():
    for arch in list_archs():
        shapes = legal_shapes(jget(arch)) + (
            ["long_500k"] if arch == "mistral-nemo-12b" else [])
        for shape in shapes:
            assert (dataclasses.asdict(tdry.arch_for(arch, shape))
                    == dataclasses.asdict(jdry.arch_for(arch, shape))), \
                (arch, shape)


def test_cli_writes_records(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m,deepseek-v2-lite-16b", "--shape", "decode_32k",
         "--override", "n_layers=2", "--out", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "failed: none" in out.stdout, out.stdout
    for arch in ("smollm-360m", "deepseek-v2-lite-16b"):
        rec = json.loads((tmp_path / f"dryrun_{arch}_decode_32k_pod16x16"
                          ".json").read_text())
        assert REPRO_KEYS <= set(rec) and "trace_seconds" in rec
        assert rec["n_chips"] == 256 and rec["mesh"] == "pod16x16"
        assert rec["hardware"] == "nvidia_h100_sxm5_80gb_700w"
        assert rec["flops_per_device"] > 0 and rec["argument_bytes"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_carried_counts_equal_every_period():
    from repro_torch.configs import get_shape
    from repro_torch.launch.mesh import make_production_mesh
    import torch.distributed as dist
    cfg = tdry.arch_for("smollm-360m", "decode_32k").variant(n_layers=3)
    tdry.start_fake_group(256)
    try:
        mesh = make_production_mesh(device="cpu")
        shape = get_shape("decode_32k")
        carried = tdry.lower_one(cfg, shape, mesh, "pod16x16")
        exact = tdry.lower_one(cfg, shape, mesh, "pod16x16",
                               {"exact": True})
    finally:
        dist.destroy_process_group()
    assert carried["periods_counted"] == [1, 2]
    assert exact["periods_counted"] == [3]
    for key in ("flops_per_device", "collective_breakdown", "argument_bytes",
                "output_bytes", "alias_bytes", "collective_counts"):
        assert carried[key] == exact[key], key


def test_codegen_fingerprint():
    from repro_torch.core.codegen import codegen_fingerprint, codegen_matches
    a = codegen_fingerprint("cpu")
    assert set(a) == {"backend", "probe"} and a["backend"] == "cpu"
    assert len(a["probe"]) == 64 and a == codegen_fingerprint("cpu")
    assert codegen_matches(a, "cpu")
    assert not codegen_matches(None, "cpu")
    assert not codegen_matches({**a, "probe": "0" * 64}, "cpu")
