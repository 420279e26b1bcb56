"""The fleet engine's pytree program (``engine="jit"``, ``flat=False``) on
the CPU against ``repro``'s pytree program from one (JAX-drawn) init, its
merges, and its raises; ``test_torch_pytree_jit_options.py`` holds it
against the port's own flat program under every option.  Tolerances are
``_torch_world.py``'s."""
from __future__ import annotations

import pytest
import torch

import repro_torch.core.aggregation as tagg
import repro_torch.core.jit_engine as tjit
import repro_torch.core.scenarios as tsc
from _torch_engines import (CAPPED, PYTREE_BATCH, fleet_run,  # noqa: F401
                            init)
from _torch_threads import one_thread  # noqa: F401
from _torch_world import assert_fleet_conforms, run_both
from repro_torch.kernels.weighted_agg import ops as agg_ops

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("name, kw", [
    ("quick-k5", {}),
    ("paper-k10", {}),
    ("quick-k5", {"use_kernel": True}),
], ids=["quick-k5", "paper-k10", "quick-k5-kernel"])
def test_pytree_jit_matches_repro_pytree(init, name, kw):
    """8 rounds of the same world through both packages' pytree programs:
    the (round, vehicle) trace exact, times and weights in the f32 band,
    params within PARAM_TOL, accuracy within 0.02.  With the kernel on,
    ``repro`` merges through its Pallas kernel in interpret mode and the
    port through K2's plain version with tensor scalars."""
    kw = {"use_kernel": False, **kw}
    jres, tres = run_both(name, init, rounds=8, engine="jit", flat=False,
                          batch_size=PYTREE_BATCH, **kw)
    assert len(tres.rounds) == 8
    assert (tres.report.engine, tres.report.waves) == (jres.report.engine,
                                                       jres.report.waves)
    assert_fleet_conforms(jres, tres)


def test_pytree_jit_merges_once_per_pop(monkeypatch):
    """Under ``use_kernel`` every pop is one ``weighted_agg_tree`` merge
    with its mix scalar a device tensor (the device form), a cap-discarded
    pop included; no ``ring_agg`` chain runs."""
    merges, chains = [], []
    real_tree = agg_ops.weighted_agg_tree

    def tree(g, l, beta, weight):
        merges.append((beta, weight))
        return real_tree(g, l, beta, weight)

    monkeypatch.setattr(agg_ops, "weighted_agg_tree", tree)
    monkeypatch.setattr(tjit.agg_ops, "ring_agg",
                        lambda *a: chains.append(a))
    res = fleet_run("quick-k5", False, rounds=12, use_kernel=True,
                    faults=CAPPED, l_iters=3)
    assert len(merges) == len(res.rounds) == 12 and not chains
    assert all(isinstance(b, torch.Tensor) and b.numel() == 1
               and w == 1.0 for b, w in merges)
    counts = res.extras["faults"]["counts"]
    assert counts["discarded_uploads"] > 0 and counts["partial_rounds"] > 0


def test_pytree_mix_keeps_g_where_the_cap_discards():
    """``arrival_mix`` with a False keep verdict returns ``g`` exactly,
    even against a non-finite upload; with True it is the mix."""
    g = {"w": torch.tensor([1.0, -2.0, 3.0])}
    loc = {"w": torch.tensor([float("inf"), 0.5, 7.0])}
    w = torch.tensor([0.8])
    kw = dict(scheme="mafl", interpretation="mixing", beta=0.5)
    kept = tagg.arrival_mix(g, loc, w, keep=torch.tensor(False), **kw)
    assert torch.equal(kept["w"], g["w"]) and kept["w"] is not g["w"]
    mixed = tagg.arrival_mix(g, loc, w, keep=torch.tensor(True), **kw)
    assert torch.equal(mixed["w"], tagg.arrival_mix(g, loc, w, **kw)["w"])


@pytest.mark.parametrize("kw, err, match", [
    (dict(ring_dtype="bf16"), ValueError, "flat fast path"),
    (dict(mesh=object()), TypeError, "DeviceMesh"),
])
def test_pytree_jit_rejects(kw, err, match):
    sc = tsc.get_scenario("quick-k5")
    veh, ti, tl, p = tsc.build_world(sc)
    with pytest.raises(err, match=match):
        tjit.run_simulation_jit(veh, ti, tl, params=p, rounds=2, flat=False,
                                device="cpu", **kw)
