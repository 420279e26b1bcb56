"""The port stands alone: no ``jax`` and nothing of ``repro`` is imported by
``repro_torch`` (its analyzers ``repro_torch.check`` included) or
``chip_smoke.py``; entry points without ``device`` run on
the card or raise; unported features raise naming their slice."""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.channel import ChannelParams
from repro_torch.configs import get_config
from repro_torch.core.client import Vehicle, VehicleData
from repro_torch.core.mafl import evaluate, run_simulation
from repro_torch.core.scenarios import (SweepSpec, get_scenario,
                                        run_scenario, run_sweep)
from repro_torch.core.sweep import run_simulation_vmap
from repro_torch.corridor import (run_corridor_simulation,
                                  run_handover_simulation)
from repro_torch.core.server import RSUServer
from repro_torch.device import resolve_device
from repro_torch.launch import serve, train
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.models.cnn import init_cnn
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_leaves_jax_out():
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 51


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module)
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imported_roots(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def _tiny_world():
    rng = np.random.default_rng(0)
    data = VehicleData(index=1, images=rng.random((8, 28, 28, 1),
                                                  dtype=np.float32),
                       labels=rng.integers(0, 10, 8).astype(np.int32))
    return data


IMPORT_ALONE = [
    "repro_torch.core.jit_engine", "repro_torch.core.flat",
    "repro_torch.configs", "repro_torch.models.transformer",
    "repro_torch.launch.serve", "repro_torch.launch.steps",
    "repro_torch.serving", "repro_torch.kernels.decode_attention.ops",
    "repro_torch.kernels.swa_attention.ops", "repro_torch.launch.train",
    "repro_torch.checkpointing", "repro_torch.kernels.cross_entropy.ops",
    "repro_torch.data", "repro_torch.check", "repro_torch.check.runner",
    "repro_torch.check.boundary", "repro_torch.check.grid_race",
    "repro_torch.check.dtype_flow", "repro_torch.check.plan_shapes",
    "repro_torch.check.corpus.racy_kernel", "repro_torch.corridor",
    "repro_torch.corridor.plan", "repro_torch.core.hierarchical",
    "repro_torch.core.sweep", "repro_torch.models.frontends",
    "repro_torch.configs.mistral_nemo_12b"]


@pytest.fixture(scope="module")
def imported_alone():
    """One fresh interpreter imports the modules of ``IMPORT_ALONE`` in
    order; after each it records the ``jax``/``repro`` modules that
    ``sys.modules`` holds (or the import's error).  ``{module: [names]}``.
    """
    code = ("import importlib, json, sys\n"
            f"mods = {IMPORT_ALONE!r}\n"
            "out = {}\n"
            "for m in mods:\n"
            "    try:\n"
            "        importlib.import_module(m)\n"
            "    except Exception as e:\n"
            "        out[m] = [f'{type(e).__name__}: {e}']\n"
            "        continue\n"
            "    out[m] = sorted(x for x in sys.modules if x == 'jax' or "
            "x.startswith(('jax.', 'repro.')) or x == 'repro')\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", IMPORT_ALONE)
def test_fleet_modules_import_alone_without_jax(module, imported_alone):
    assert imported_alone[module] == [], imported_alone[module]


@pytest.mark.parametrize("entry", [
    "resolve_device", "run_scenario", "run_simulation", "evaluate",
    "Vehicle", "RSUServer", "run_simulation_jit", "init_params",
    "init_cache", "serve", "train", "run_corridor_simulation",
    "run_handover_simulation", "run_sweep", "run_simulation_vmap"])
def test_entry_points_default_to_the_card(entry):
    """``device=None`` means the card: without one the call raises instead
    of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    data = _tiny_world()
    params = init_cnn(torch.Generator().manual_seed(0), device="cpu")
    corridor = dataclasses.replace(get_scenario("corridor-quick-r2-k8"),
                                   K=1, rounds=1)
    calls = {
        "resolve_device": lambda: resolve_device(None),
        "run_scenario": lambda: run_scenario("quick-k5", rounds=1),
        "run_simulation": lambda: run_simulation(
            [data], data.images, data.labels,
            params=ChannelParams(K=1), rounds=1),
        "evaluate": lambda: evaluate(params, data.images, data.labels),
        "Vehicle": lambda: Vehicle(data),
        "RSUServer": lambda: RSUServer(params, ChannelParams()),
        "run_simulation_jit": lambda: run_simulation(
            [data], data.images, data.labels,
            params=ChannelParams(K=1), rounds=1, engine="jit"),
        "init_params": lambda: T.init_params(
            get_config("smollm-360m").reduced(), torch.Generator()),
        "init_cache": lambda: T.init_cache(
            get_config("smollm-360m").reduced(), 1, 8),
        "serve": lambda: serve.main(["--reduced"]),
        "train": lambda: train.main(["--reduced", "--rounds", "1"]),
        "run_corridor_simulation": lambda: run_corridor_simulation(
            corridor, [data], data.images, data.labels),
        "run_handover_simulation": lambda: run_handover_simulation(
            corridor, [data], data.images, data.labels, corridor.channel()),
        "run_sweep": lambda: run_sweep(SweepSpec(scenario="quick-k5")),
        "run_simulation_vmap": lambda: run_simulation_vmap(
            [(get_scenario("quick-k5"), 0)]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.mark.parametrize("kwargs, slice_name", [
    (dict(scenario="corridor-quick-r2-k8", flat=False, mesh=object()),
     "item 13"),
    (dict(scenario="quick-k5", engine="jit", flat=False, mesh=object()),
     "item 13"),
    (dict(scenario="quick-k5", engine="jit", mesh=object()),
     "distribution"),
    (dict(scenario="fleet-k1000", engine="jit", mesh=object()),
     "distribution"),
    (dict(scenario="corridor-quick-r2-k8", mesh=object()),
     "distribution"),
    (dict(scenario="corridor-quick-r2-k8", flat=False, record_cohorts=True,
          mesh=object()), "item 13"),
])
def test_unported_features_raise_naming_their_slice(kwargs, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        run_scenario(device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs, policy", [
    (dict(scenario="corridor-r4-k400-bandit"), "eps-bandit"),
    (dict(scenario="fleet-k1000-topk", engine="jit"), "weighted-topk"),
    (dict(scenario="fleet-k1000-topk"), "weighted-topk"),
])
def test_selection_worlds_run_on_the_port(kwargs, policy):
    """The selection worlds that raised before selection was ported, cut
    to K 40 and 10 rounds (k 5 per RSU, so the policy parks vehicles)."""
    res = run_scenario(device="cpu", K=40, rounds=10, eval_every=10,
                       selection_k=5, n_train=1200, n_test=120, **kwargs)
    assert len(res.rounds) == 10
    summary = res.report.selection
    assert summary["policy"] == policy and len(summary["admit0"]) == 40
    admitted = {v for v, m in enumerate(summary["admit0"]) if m}
    assert len(admitted) < 40
    # nothing parked at t = 0 arrives before the first re-score
    first = min([b for b, _, _ in summary["decisions"]] + [10])
    assert {r.vehicle for r in res.rounds[:first]} <= admitted


@pytest.mark.parametrize("name", ["fleet-k1000-flaky",
                                  "fleet-k1000-throttled",
                                  "corridor-rush-hour-deadzone-r8-k4000"])
def test_fault_worlds_run_on_the_port(name):
    """The fault worlds that raised before faults were ported, cut to K 40
    and 10 rounds on their default engine: the summary is the port's own
    host replay's (held to ``repro``'s in ``tests/test_torch_faults.py``)."""
    from repro_torch.faults import (replay_corridor_faults,
                                    replay_fleet_faults, scenario_faults)
    cut = dict(K=40, rounds=10, n_train=1200, n_test=120)
    sc = dataclasses.replace(get_scenario(name), **cut)
    spec = scenario_faults(sc)
    if sc.n_rsus > 1:
        want = replay_corridor_faults(
            sc.channel(), sc.n_rsus, 0, 10, spec, l_iters=sc.l_iters,
            entry=sc.corridor_entry, reconcile_every=sc.reconcile_every)
    else:
        want = replay_fleet_faults(sc.channel(), 0, 10, spec,
                                   l_iters=sc.l_iters)
    res = run_scenario(name, device="cpu", eval_every=10, **cut)
    assert len(res.rounds) == 10
    assert res.extras["faults"] == want.summary(sc.l_iters)
    assert res.extras["faults"]["spec"]["staleness_cap"] is not None


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        run_scenario("quick-k5", engine="nope", device="cpu")


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v2-lite-16b", "rwkv6-1.6b",
                                  "jamba-v0.1-52b"])
def test_unported_arch_raises_naming_item_12(arch):
    """Item 12's SSM archs (part 4) still raise from ``get_config``; the
    MoE + MLA archs (part 3) are registered and build reduced models."""
    if arch in ("rwkv6-1.6b", "jamba-v0.1-52b"):
        with pytest.raises(NotImplementedError, match="item 12"):
            get_config(arch)
        return
    cfg = get_config(arch).reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    logits, aux = T.forward(cfg, model, torch.zeros(1, 4, dtype=torch.int64))
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert torch.isfinite(logits).all() and float(aux) > 0


@pytest.mark.parametrize("mask_kind", ["swa", "chunk"])
def test_non_full_mask_raises_naming_item_12(mask_kind):
    """Sliding-window and chunked masks are ported (item 12's first part);
    what still raises is a ring cache with per-sequence positions: a ring
    takes one position for the batch (``repro`` asserts so), so a ``[B]``
    position vector raises ``ValueError`` before the cache is written."""
    cfg = get_config("smollm-360m").reduced()
    p = attention.init_attention(cfg, torch.Generator(), device="cpu")
    x = torch.zeros(2, 1, cfg.d_model)
    cache = attention.init_attn_cache(cfg, 2, 8, mask_kind, 4, torch.float32,
                                      "cpu")
    with pytest.raises(ValueError, match="scalar position"):
        attention.attention_decode(cfg, p, x, cache, torch.tensor([1, 2]),
                                   mask_kind, 4)
    assert not any(v.any() for v in cache.values())
