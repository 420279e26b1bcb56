"""The corridor engine's pytree program (``flat=False``) on the CPU
against ``repro``'s pytree program from one (JAX-drawn) init, its rows
and launches, and its raises; ``test_torch_pytree_corridor_options.py``
holds it against the port's own flat program under every option.
Tolerances are ``_torch_world.py``'s."""
from __future__ import annotations

import dataclasses

import pytest
import torch

import repro_torch.core.scenarios as tsc
import repro_torch.corridor.engine as tengine
from _torch_engines import (QUICK, assert_corridor_conforms,  # noqa: F401
                            corridor_run, init, leaves_equal)
from _torch_threads import one_thread  # noqa: F401
from repro_torch.corridor import run_corridor_simulation
from repro_torch.kernels.weighted_agg import ops as agg_ops

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(reconcile_mode="ema", reconcile_tau=0.3, use_kernel=True,
         metrics="on"),
], ids=["fedavg", "ema-kernel-metrics"])
def test_pytree_corridor_matches_repro_pytree(init, kw):
    """corridor-quick-r2-k8 for 8 rounds through both packages' pytree
    programs with ``record_cohorts``: the (round, vehicle, rsu) trace
    exact, times in the f32 band, params within PARAM_TOL, accuracy within
    0.02, every cohort snapshot within PARAM_TOL.  With the kernel on,
    ``repro`` merges each arrival and the EMA reconcile through its Pallas
    kernel in interpret mode."""
    kw = dict(kw, rounds=8, record_cohorts=True)
    jres = corridor_run(QUICK, False, package="repro", **dict(kw))
    tres = corridor_run(QUICK, False, init, **dict(kw))
    assert tres.report.metrics_on == jres.report.metrics_on
    assert_corridor_conforms(jres, tres, "corridor")
    snaps = tres.extras["cohort_snapshots"]
    assert len(snaps) == len(jres.extras["cohort_snapshots"]) == 2
    for tsnap, jsnap in zip(snaps, jres.extras["cohort_snapshots"]):
        for k, v in jsnap.items():
            torch.testing.assert_close(
                tsnap[k], torch.from_numpy(v.__array__().copy()),
                rtol=1e-4, atol=2e-5)


def test_pytree_corridor_rows_stay_as_stored(monkeypatch):
    """Every row a merge returns (ring rows are views of them) is bitwise
    as it was made at the end of the run, though the stack is written in
    place at every pop and reconciled: no ring row aliases the stack.
    Under the kernel with the EMA reconcile, K2 launches once a pop (the
    device form) plus once a reconcile (the host form), and no chain
    runs."""
    made, merges, chains = [], [], []
    real_mix = tengine.arrival_mix
    real_tree = agg_ops.weighted_agg_tree

    def mix(*a, **kw):
        out = real_mix(*a, **kw)
        made.append((out, {k: v.clone() for k, v in out.items()}))
        return out

    def tree(g, l, beta, weight):
        merges.append(isinstance(beta, torch.Tensor))
        return real_tree(g, l, beta, weight)

    monkeypatch.setattr(tengine, "arrival_mix", mix)
    monkeypatch.setattr(agg_ops, "weighted_agg_tree", tree)
    monkeypatch.setattr(tengine.agg_ops, "ring_agg",
                        lambda *a: chains.append(a))
    res = corridor_run(QUICK, False, rounds=16, use_kernel=True,
                       reconcile_mode="ema", reconcile_tau=0.3)
    assert len(made) == 16 and all(leaves_equal(out, copy)
                                   for out, copy in made)
    reconciles = 16 // tsc.get_scenario(QUICK).reconcile_every
    assert sorted(merges) == [False] * reconciles + [True] * 16
    assert not chains and res.extras["n_rsus"] == 2


@pytest.mark.parametrize("kw, err, match", [
    (dict(ring_dtype="bf16"), ValueError, "flat fast path"),
    (dict(mesh=object()), NotImplementedError, "item 13"),
])
def test_pytree_corridor_rejects(kw, err, match):
    fields = {k: kw.pop(k) for k in ("ring_dtype",) if k in kw}
    sc = dataclasses.replace(tsc.get_scenario(QUICK), rounds=2, **fields)
    veh, ti, tl, p = tsc.build_world(sc)
    with pytest.raises(err, match=match):
        run_corridor_simulation(sc, veh, ti, tl, p, flat=False,
                                device="cpu", **kw)
