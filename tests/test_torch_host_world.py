"""The port's host f64 world against ``repro``'s, with exact equality:
synthetic data, shards, channel gains, rates, distances, delay weights, the
event queue, the scenario registry, and the timeline's pop sequences."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.channel as jch
import repro.core.events as jev
import repro.core.mafl as jmafl
import repro.core.scenarios as jsc
import repro.core.weights as jw
import repro.data as jdata
import repro_torch.channel as tch
import repro_torch.core.events as tev
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
import repro_torch.core.weights as tw
import repro_torch.data as tdata
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_synth_mnist_exact():
    for a, b in zip(jdata.synth_mnist(300, 120, seed=3, noise=0.4),
                    tdata.synth_mnist(300, 120, seed=3, noise=0.4)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["paper-k10", "fleet-k100",
                                  "paper-k10-noniid"])
def test_build_world_shards_exact(name):
    jv, jti, jtl, jp = jsc.build_world(jsc.get_scenario(name), seed=1)
    tv, tti, ttl, tp = tsc.build_world(tsc.get_scenario(name), seed=1)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    np.testing.assert_array_equal(jti, tti)
    np.testing.assert_array_equal(jtl, ttl)
    assert len(jv) == len(tv)
    for a, b in zip(jv, tv):
        assert a.index == b.index and a.size == b.size
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_scenario_registry_exact():
    assert jsc.list_scenarios() == tsc.list_scenarios()
    for name in jsc.list_scenarios():
        assert (dataclasses.asdict(jsc.get_scenario(name))
                == dataclasses.asdict(tsc.get_scenario(name)))
        assert (dataclasses.asdict(jsc.get_scenario(name).channel())
                == dataclasses.asdict(tsc.get_scenario(name).channel()))


@pytest.mark.parametrize("K, platoon", [(10, 0), (100, 0), (60, 25)])
def test_channel_exact(K, platoon):
    jp = jch.ChannelParams(K=K, platoon=platoon)
    tp = tch.ChannelParams(K=K, platoon=platoon)
    # fading: step, steps_block, the slot cache and the prefix-scan table
    jf, tf = jch.RayleighAR1(jp, seed=7), tch.RayleighAR1(tp, seed=7)
    np.testing.assert_array_equal(jf.step(), tf.step())
    np.testing.assert_array_equal(jf.steps_block(9), tf.steps_block(9))
    assert jf.gain(3) == tf.gain(3)
    jc = jch.SlotGainCache(jch.RayleighAR1(jp, seed=2))
    tc = tch.SlotGainCache(tch.RayleighAR1(tp, seed=2))
    for t in (0.5, 3.2, 3.9, 11.0, 40.7):
        np.testing.assert_array_equal(jc.at(t), tc.at(t))
        jc.prune_below(t - 2)
        tc.prune_below(t - 2)
        assert len(jc) == len(tc) and jc.last_slot == tc.last_slot
    np.testing.assert_array_equal(jch.slot_gain_table(jp, 5, 33),
                                  tch.slot_gain_table(tp, 5, 33))
    # mobility, both geometries
    ts = np.linspace(0.0, 300.0, 17)
    jm, tm = jch.Mobility(jp), tch.Mobility(tp)
    for i in (0, K // 2, K - 1):
        for t in ts:
            assert jm.distance(i, t) == tm.distance(i, t)
            np.testing.assert_array_equal(jm.position(i, t),
                                          tm.position(i, t))
    np.testing.assert_array_equal(jm.distances(ts[:, None]),
                                  tm.distances(ts[:, None]))
    np.testing.assert_array_equal(jm.next_boundary_crossing(3, ts),
                                  tm.next_boundary_crossing(3, ts))
    for entry in ("uniform", "rush"):
        jcm = jch.CorridorMobility(jp, 4, entry=entry)
        tcm = tch.CorridorMobility(tp, 4, entry=entry)
        np.testing.assert_array_equal(jcm.positions(ts), tcm.positions(ts))
        np.testing.assert_array_equal(jcm.serving_cells(ts),
                                      tcm.serving_cells(ts))
        np.testing.assert_array_equal(jcm.distances(ts[:, None]),
                                      tcm.distances(ts[:, None]))
        np.testing.assert_array_equal(
            jcm.next_boundary_crossing(np.arange(K), 12.5),
            tcm.next_boundary_crossing(np.arange(K), 12.5))
    # rates, delays and the delay weights (Eqs. 5-9)
    for i1 in (1, K // 2, K):
        assert jch.training_delay(jp, i1) == tch.training_delay(tp, i1)
    for gain, dist in [(0.3, 12.0), (1.7, 250.0), (1e-9, 400.0)]:
        r = jch.shannon_rate(jp, gain, dist)
        assert r == tch.shannon_rate(tp, gain, dist)
        assert jch.upload_delay(jp, r) == tch.upload_delay(tp, r)
    for cu, cl in [(0.2, 3.0), (1.0, 1.0), (7.5, 0.4)]:
        assert jw.upload_weight(jp, cu) == tw.upload_weight(tp, cu)
        assert jw.training_weight(jp, cl) == tw.training_weight(tp, cl)
        assert (jw.combined_weight(jp, cu, cl)
                == tw.combined_weight(tp, cu, cl))


def test_event_queue_exact():
    jq, tq = jev.EventQueue(), tev.EventQueue()
    rng = np.random.default_rng(0)
    times = np.round(rng.random(40) * 5, 1)           # many exact ties
    for v, t in enumerate(times):
        jq.push(float(t), v % 7, cycle=v)
        tq.push(float(t), v % 7, cycle=v)
    for k, v in jq.as_struct_arrays().items():
        np.testing.assert_array_equal(v, tq.as_struct_arrays()[k])
    while len(jq):
        a, b = jq.pop(), tq.pop()
        assert (a.time, a.seq, a.vehicle, a.cycle) == (
            b.time, b.seq, b.vehicle, b.cycle)
    assert len(tq) == 0 and tq.earliest_time() == float("inf")


def _pops(mod, p, seed, n):
    tl = mod._Timeline(p, seed)
    for k in range(p.K):
        tl.schedule(k, 0.0)
    out = []
    for _ in range(n):
        ev = tl.queue.pop()
        out.append((ev.time, ev.vehicle, ev.cycle, ev.download_time,
                    ev.train_delay, ev.upload_delay))
        tl.schedule(ev.vehicle, ev.time)
        tl.prune()
    return out


@pytest.mark.parametrize("name, seed", [("paper-k10", 0), ("paper-k10", 3),
                                        ("fleet-k100", 0)])
def test_timeline_pops_and_consumed_set_exact(name, seed):
    sc = jsc.get_scenario(name)
    jp, tp = jsc.get_scenario(name).channel(), tsc.get_scenario(
        name).channel()
    assert _pops(jmafl, jp, seed, sc.rounds) == _pops(tmafl, tp, seed,
                                                       sc.rounds)
    assert (jmafl._consumed_events(jp, seed, sc.rounds)
            == tmafl._consumed_events(tp, seed, sc.rounds))
