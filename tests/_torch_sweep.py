"""Shared by the sweep engine's tests (``test_torch_sweep_*.py``): the
W = 4 grid, the bitwise digest of a run (``_torch_engines.digest``), the
port's sweep from ``repro``'s inits, the port's solo ``jit`` run, a batch
of singleton groups against its solo runs, and the band a world of a
shared timeline group is held to against its solo run."""
from __future__ import annotations

import numpy as np

import repro_torch.core.scenarios as tsc
from _torch_engines import digest
from _torch_world import ACC_TOL, PARAM_TOL, jax_init
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import jit_engine as tjit
from repro_torch.core import sweep as tsweep
from repro_torch.kernels.weighted_agg import ops as agg_ops

# the W = 4 grid of the CPU tests: 2 betas x 2 seeds, quick-k5, 8 rounds
GRID = dict(scenario="quick-k5", seeds=(0, 1),
            variants=tuple((("channel_overrides", (("beta", b),)),)
                           for b in (0.3, 0.7)),
            overrides=(("rounds", 8),), eval_every=4)


def port_vmap_from_jax(worlds, eval_every):
    """The port's sweep of ``worlds`` from ``repro``'s ``init_cnn`` weights
    of each world's seed."""
    inits = {seed: params_from_jax(jax_init(seed), "cpu")
             for _, seed in worlds}
    return tsweep.run_simulation_vmap(
        worlds, eval_every=eval_every,
        init_params=[inits[seed] for _, seed in worlds], device="cpu")


def assert_band(res, solo):
    """A world of a shared timeline group against its solo run: the same
    trace bit for bit (it never reads a parameter), params within
    ``PARAM_TOL``, accuracy within 0.02."""
    assert digest(res)[0] == digest(solo)[0]
    a, b = params_to_numpy(res.final_params), params_to_numpy(
        solo.final_params)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **PARAM_TOL)
    assert [r for r, _ in res.acc_history] == [r for r, _ in
                                               solo.acc_history]
    for (_, x), (_, y) in zip(res.acc_history, solo.acc_history):
        assert abs(x - y) <= ACC_TOL


def port_solo(sc, seed, eval_every):
    """The port's solo ``jit`` run of one world, on its torch init."""
    return tsc.run_scenario(sc, engine="jit", seed=seed,
                            eval_every=eval_every, device="cpu")


def assert_singletons_are_solo(worlds, monkeypatch, rounds=8,
                               eval_every=4):
    """A batch of worlds, each alone in its timeline group: one
    ``ring_agg`` call of all worlds per union chain end, covering every
    pop once, and every world bitwise its solo port run."""
    calls = []
    real = agg_ops.ring_agg

    def counted(g, locs, coeffs):
        calls.append((tuple(g.shape), tuple(locs.shape[:2])))
        return real(g, locs, coeffs)

    monkeypatch.setattr(agg_ops, "ring_agg", counted)
    vm = tsweep.run_simulation_vmap(worlds, eval_every=eval_every,
                                    device="cpu")
    plans = [tjit.plan_fleet(sc.channel(), seed, rounds)
             for sc, seed in worlds]
    ends = tsweep.chain_ends(plans, tjit.eval_rounds_of(rounds, eval_every))
    W = len(worlds)
    assert [g[0] for g, _ in calls] == [W] * len(ends)
    assert [u for (_, u) in calls] == [(W, b - a) for a, b in
                                       zip([0] + ends[:-1], ends)]
    assert [r.report.channels["group"] for r in vm] == list(range(W))
    for (sc, seed), v in zip(worlds, vm):
        assert digest(v) == digest(port_solo(sc, seed, eval_every))
