"""The host side of the port's telemetry against ``repro.telemetry``, on the
CPU: the planner's spec and edges (bit for bit), the f64 channel replays
(exactly, on the registry worlds the engines' tests use), the metrics
normalisation, ``wave_stats``, the ``RunReport`` JSON both ways, the run
log and the CLI, and rule TEL001's probe.  A cross-framework check runs
``repro``'s fleet engine and the port's on one K 4 world and init with
metrics on: ``repro``'s ``runlog.diff`` finds the histogram and the
occupancy identical, and each package's reader loads the other's line."""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.jit_engine as jjit
import repro.core.mafl as jmafl
import repro.core.scenarios as jsc
import repro.data as jdata
import repro.faults as jfaults
import repro.telemetry.replay as jreplay
import repro.telemetry.report as jreport
import repro.telemetry.runlog as jrunlog
import repro.telemetry.spec as jspec
import repro_torch.core.jit_engine as tjit
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
import repro_torch.data as tdata
import repro_torch.faults as tfaults
import repro_torch.telemetry.replay as treplay
import repro_torch.telemetry.report as treport
import repro_torch.telemetry.runlog as trunlog
import repro_torch.telemetry.spec as tspec
from _torch_world import jax_init
from repro.channel import ChannelParams as JParams
from repro_torch.channel import ChannelParams as TParams
from repro_torch.convert import params_from_jax
from repro_torch.telemetry.__main__ import main as tmain
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


# ---------------------------------------------------------------------------
# the planner: spec and edges
# ---------------------------------------------------------------------------
def test_edges_keep_safe_margin_from_samples():
    """``repro``'s own trials: every edge a safe margin from every sample,
    f32 and f64 staleness bucket alike, and the edges (and margins) equal
    ``repro``'s bit for bit."""
    rng = np.random.default_rng(7)
    for _ in range(20):
        times = np.sort(rng.uniform(0.0, 3000.0, 64))
        stale = rng.uniform(0.0, 50.0, 64)
        edges = tspec.plan_stale_edges(stale, times)
        assert edges == jspec.plan_stale_edges(stale, times)
        margin = tspec.stale_margin(times)
        assert margin == jspec.stale_margin(times)
        for e in edges:
            assert np.min(np.abs(stale - e)) > margin
        f32_stale = np.float64(np.float32(stale))
        assert np.array_equal(tspec.bucket_indices(edges, stale),
                              tspec.bucket_indices(edges, f32_stale))
        assert np.all(np.diff(edges) > 0)
        for n_bins in (1, 2, 5, 16):
            assert (tspec.plan_stale_edges(stale, times, n_bins)
                    == jspec.plan_stale_edges(stale, times, n_bins))


@pytest.mark.parametrize("name, n_rsus", [("quick-k5", 1),
                                          ("fleet-k100", 1),
                                          ("corridor-quick-r2-k8", 2)])
def test_spec_from_the_plan_equals_repro(name, n_rsus):
    """The spec the engines resolve from their f64 plan (staleness and pop
    times of the dry run) is ``repro``'s, edges bit for bit."""
    rounds = 12
    jchan = jsc.get_scenario(name).channel()
    tchan = tsc.get_scenario(name).channel()
    if n_rsus > 1:
        from repro.corridor.plan import plan_corridor as jplan
        from repro_torch.corridor import plan_corridor as tplan
        jp = jplan(jchan, n_rsus, 0, rounds)
        tp = tplan(tchan, n_rsus, 0, rounds)
    else:
        jp = jjit.plan_fleet(jchan, 0, rounds)
        tp = tjit.plan_fleet(tchan, 0, rounds)
    kw = dict(n_rsus=n_rsus, ring_guard=True, fault_counters=False)
    mine = tspec.resolve_metrics("on", stale=tp.times - tp.download_time,
                                 times=tp.times, **kw)
    ref = jspec.resolve_metrics("on", stale=jp.times - jp.download_time,
                                times=jp.times, **kw)
    assert mine.to_json() == ref.to_json()
    assert mine.edges and all(float(np.float32(e)) == e
                              for e in mine.edges)
    stale = tp.times - tp.download_time
    rsu = tp.up_rsu if n_rsus > 1 else None
    assert np.array_equal(
        tspec.stale_histogram(mine.edges, stale, rsu=rsu, n_rsus=n_rsus),
        jspec.stale_histogram(ref.edges, stale, rsu=rsu, n_rsus=n_rsus))


@pytest.mark.parametrize("setting", [
    None, False, "off", True, "on", "enabled", "sometimes", 0, 1,
    "spec-on", "spec-off"])
def test_metrics_requested_normalization(setting):
    """``repro``'s rules: None, False, "off" and a disabled spec are off;
    True, "on" and a spec are on; anything else raises ``ValueError``."""
    def as_spec(mod):
        if setting == "spec-on":
            return mod.MetricsSpec(enabled=True)
        if setting == "spec-off":
            return mod.MetricsSpec(enabled=False)
        return setting

    try:
        want = jspec.metrics_requested(as_spec(jspec))
    except ValueError:
        with pytest.raises(ValueError, match="unknown metrics setting"):
            tspec.metrics_requested(as_spec(tspec))
        return
    assert tspec.metrics_requested(as_spec(tspec)) is want
    res = tspec.resolve_metrics(as_spec(tspec), stale=np.ones(3),
                                times=np.ones(3))
    assert (res is None) is (not want)


def test_wave_stats():
    waves = (((0, 1, 2), 0, 3), ((3, 4), 3, 5))
    s = treport.wave_stats(waves, k=4)
    assert s["n_waves"] == 2 and s["sizes"] == [3, 2]
    assert s["total_trained"] == 5 and s["max_fill"] == 3
    assert s["utilization_vs_fleet"] == pytest.approx(5 / 8)
    plan = tjit.plan_fleet(TParams(K=100), 0, 30)
    for w, k in ((waves, 4), ((), 4), (plan.waves, 100)):
        assert treport.wave_stats(w, k) == jreport.wave_stats(w, k)


# ---------------------------------------------------------------------------
# the f64 channel replay
# ---------------------------------------------------------------------------
REPLAY_WORLDS = [
    ("quick-k5", {}),
    ("fleet-k100", dict(rounds=12)),
    ("corridor-quick-r2-k8", {}),
    ("fleet-k1000-flaky", dict(K=40)),
    ("fleet-k1000-throttled", dict(K=40)),
    ("corridor-rush-hour-deadzone-r8-k4000", dict(K=40)),
    ("corridor-r4-k400-bandit", dict(K=40, selection_k=5)),
]


def replays(name, **cut):
    """``repro``'s and the port's f64 channel replay of a registry world
    cut by ``cut``, each package driving its own selection and fault
    specs."""
    out = []
    for sc_mod, flt_mod, rep in ((jsc, jfaults, jreplay),
                                 (tsc, tfaults, treplay)):
        sc = dataclasses.replace(sc_mod.get_scenario(name), **cut)
        kw = dict(selection=sc.selection_spec(),
                  faults=flt_mod.scenario_faults(sc), l_iters=sc.l_iters)
        if sc.n_rsus > 1:
            out.append(rep.replay_corridor_channels(
                sc.channel(), sc.n_rsus, 0, sc.rounds,
                entry=sc.corridor_entry,
                reconcile_every=sc.reconcile_every, **kw))
        else:
            out.append(rep.replay_fleet_channels(sc.channel(), 0, sc.rounds,
                                                 **kw))
    return out


@pytest.mark.parametrize("name, cut", REPLAY_WORLDS,
                         ids=[n for n, _ in REPLAY_WORLDS])
def test_replay_equals_repro(name, cut):
    ref, mine = replays(name, **cut)
    assert set(mine) == set(ref)
    for k, v in ref.items():
        assert mine[k].dtype == v.dtype, k
        assert np.array_equal(mine[k], v), k
    if "handover" in ref:
        assert mine["occupancy"].shape[1] > 1


# ---------------------------------------------------------------------------
# reports, run logs and the CLI
# ---------------------------------------------------------------------------
def _k4_world(data, params):
    """``repro``'s telemetry-test world (K 4) in one package."""
    tr_i, tr_l, te_i, te_l = data.synth_mnist(n_train=256, n_test=64,
                                              seed=0)
    p = dataclasses.replace(params(), K=4)
    veh = data.partition_vehicles(tr_i, tr_l, p, seed=0, scale=0.03)
    return veh, te_i, te_l, p


K4_RUN = dict(scheme="mafl", rounds=8, l_iters=1, lr=0.05, seed=0,
              eval_every=8, engine="jit", batch_size=32)


@pytest.fixture(scope="module")
def cross_runs():
    """``repro``'s fleet engine and the port's on the K 4 world from one
    init, metrics on."""
    init = jax_init()
    veh, ti, tl, p = _k4_world(jdata, JParams)
    jres = jmafl.run_simulation(
        veh, ti, tl, params=p, metrics="on",
        init_params={k: jnp.asarray(v) for k, v in init.items()}, **K4_RUN)
    veh, ti, tl, p = _k4_world(tdata, TParams)
    tres = tmafl.run_simulation(
        veh, ti, tl, params=p, metrics="on", device="cpu",
        init_params=params_from_jax(init, "cpu"), **K4_RUN)
    return jres, tres


def test_cross_framework_logs(cross_runs, tmp_path):
    """One log line from each package: each reader loads the other's,
    and ``repro``'s ``runlog.diff`` finds the histogram and the occupancy
    identical and the gap within the f32 band."""
    jres, tres = cross_runs
    jlog, tlog = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    jrunlog.append(str(jlog), jres.report)
    trunlog.append(str(tlog), tres.report)
    mine = jrunlog.load(str(tlog))[-1]          # repro reads the port
    ref = trunlog.load(str(jlog))[-1]           # the port reads repro
    assert jreport.RunReport.from_json(mine).engine == "jit"
    assert treport.RunReport.from_json(ref).engine == "jit"
    text = jrunlog.diff(ref, mine)
    assert "channel stale_hist         identical" in text
    assert "channel occupancy          identical" in text
    assert trunlog.diff(ref, mine) == text
    assert set(mine) == set(ref)
    for k in ("engine", "scheme", "rounds", "seed", "metrics_on", "spec",
              "waves"):
        assert mine[k] == ref[k], k
    assert set(mine["phases"]) == set(ref["phases"]) - {"build"}
    assert set(mine["channels"]) == set(ref["channels"])
    np.testing.assert_allclose(mine["channels"]["gap"],
                               ref["channels"]["gap"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mine["channels"]["reward"],
                               ref["channels"]["reward"], rtol=1e-5)


def test_report_json_roundtrip(cross_runs):
    _, tres = cross_runs
    d = tres.report.to_json()
    json.dumps(d)                      # fully serializable
    back = treport.RunReport.from_json(d)
    assert back.engine == "jit" and back.metrics_on
    assert back.channels["stale_hist"] == d["channels"]["stale_hist"]
    assert back == treport.RunReport.from_json(json.loads(json.dumps(d)))
    bad = dict(d, schema="repro.telemetry/v0")
    with pytest.raises(ValueError, match="schema"):
        treport.RunReport.from_json(bad)
    assert d["schema"] == treport.SCHEMA == jreport.SCHEMA


def test_plain_takes_tensors():
    import torch
    x = {"a": torch.arange(3, dtype=torch.int32), "b": torch.tensor(1.5),
         "c": torch.ones(2, dtype=torch.bfloat16), "d": (np.int64(2),
                                                         np.float32(0.5))}
    assert treport._plain(x) == {"a": [0, 1, 2], "b": 1.5, "c": [1.0, 1.0],
                                 "d": [2, 0.5]}


def test_runlog_roundtrip_render_and_diff(cross_runs, tmp_path):
    _, tres = cross_runs
    veh, ti, tl, p = _k4_world(tdata, TParams)
    off = tmafl.run_simulation(veh, ti, tl, params=p, device="cpu",
                               **K4_RUN)
    log = tmp_path / "runs.jsonl"
    trunlog.append(str(log), tres.report)
    trunlog.append(str(log), off.report)
    runs = trunlog.load(str(log))      # schema-checked dicts
    assert len(runs) == 2
    assert runs[0]["metrics_on"] and not runs[1]["metrics_on"]
    text = trunlog.render(runs)
    assert text == jrunlog.render(runs)
    assert "jit" in text and "staleness hist" in text
    dtext = trunlog.diff(runs[0], runs[1])
    assert "metrics_on" in dtext and dtext == jrunlog.diff(runs[0], runs[1])
    (tmp_path / "bad.jsonl").write_text(
        json.dumps(dict(runs[0], schema="nope")) + "\n")
    with pytest.raises(ValueError, match="schema"):
        trunlog.load(str(tmp_path / "bad.jsonl"))


def test_cli_report_diff_and_run(cross_runs, tmp_path, capsys):
    jres, tres = cross_runs
    log, jlog = tmp_path / "runs.jsonl", tmp_path / "jax.jsonl"
    trunlog.append(str(log), tres.report)
    jrunlog.append(str(jlog), jres.report)
    assert tmain(["report", str(log)]) == 0
    assert "jit" in capsys.readouterr().out
    assert tmain(["diff", str(jlog), str(log)]) == 0
    assert "identical" in capsys.readouterr().out
    (tmp_path / "empty.jsonl").write_text("")
    assert tmain(["report", str(tmp_path / "empty.jsonl")]) == 1
    out = tmp_path / "run.jsonl"
    assert tmain(["run", "quick-k5", "--engine", "jit", "--device", "cpu",
                  "--eval-every", "5", "--out", str(out)]) == 0
    assert "quick-k5 [jit] metrics=on" in capsys.readouterr().out
    (line,) = trunlog.load(str(out))
    assert line["scenario"] == "quick-k5" and line["metrics_on"]
    assert sum(line["channels"]["stale_hist"]) == line["rounds"] == 10


def test_phase_timers_and_memory(cross_runs):
    _, tres = cross_runs
    phases = tres.report.phases
    assert set(phases) == {"plan", "stage", "run", "eval"}
    assert all(v >= 0.0 for v in phases.values())
    # a CPU run: the process's peak RSS and no device keys
    assert set(tres.report.memory) == {"peak_rss_bytes"}
    assert tres.report.memory["peak_rss_bytes"] > 0


# ---------------------------------------------------------------------------
# rule TEL001
# ---------------------------------------------------------------------------
def test_telemetry_off_probe_clean():
    from repro_torch.check.telemetry_off import probe_telemetry_off
    assert probe_telemetry_off() == []


def test_telemetry_off_probe_sees_an_extra_op(monkeypatch):
    """Made to resolve ``"off"`` to an enabled spec inside both device
    engines (the resolution itself untouched), the off runs dispatch the
    telemetry ops: one finding per engine, none for the resolution."""
    from repro_torch.check.telemetry_off import probe_telemetry_off
    from repro_torch.corridor import engine as tengine

    def leaky(metrics, **kw):
        return tspec.resolve_metrics("on" if metrics == "off" else metrics,
                                     **kw)

    monkeypatch.setattr(tjit, "resolve_metrics", leaky)
    monkeypatch.setattr(tengine, "resolve_metrics", leaky)
    found = probe_telemetry_off()
    assert {f.rule for f in found} == {"TEL001"}
    assert sorted(f.path for f in found) == [
        "<probe:telemetry-off-corridor>", "<probe:telemetry-off-jit>"]
    assert all("metrics='off' dispatched" in f.message for f in found)
