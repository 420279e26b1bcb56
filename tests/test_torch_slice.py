"""The slice end to end: the port's ``run_simulation`` against ``repro``'s on
the same world from the same (JAX-drawn) init, with the kernel path on
(``use_kernel=True``; on CPU tensors the port's wrapper runs its plain
version, JAX's runs the Pallas kernel in interpret mode).  Tolerances are
stated in ``_torch_world.py``."""
from __future__ import annotations

import pytest
import torch

import repro.core.scenarios as jsc
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
from _torch_world import assert_conforms, jax_init, run_both
from repro_torch.convert import params_from_jax


@pytest.fixture(scope="module")
def init():
    return jax_init()


@pytest.mark.parametrize("name, engine, rounds", [
    ("quick-k5", "serial", 6),
    ("quick-k5", "batched", 6),
    ("paper-k10", "serial", 8),
])
def test_run_simulation_matches_repro(init, name, engine, rounds):
    jres, tres = run_both(name, init, rounds=rounds, engine=engine)
    assert len(tres.rounds) == rounds
    assert_conforms(jres, tres)


def test_batched_chunks_match_serial_in_the_port(init):
    """wave_chunk=2 puts quick-k5's waves through the vmapped chunk path:
    same trace as the serial engine, params to f32 tolerance."""
    sc = tsc.get_scenario("quick-k5")
    veh, ti, tl, p = tsc.build_world(sc)
    kw = dict(scheme=sc.scheme, rounds=5, l_iters=sc.l_iters, lr=sc.lr,
              params=p, eval_every=5, use_kernel=True, device="cpu")
    ser = tmafl.run_simulation(veh, ti, tl, engine="serial",
                               init_params=params_from_jax(init, "cpu"), **kw)
    bat = tmafl.run_simulation(veh, ti, tl, engine="batched", wave_chunk=2,
                               init_params=params_from_jax(init, "cpu"), **kw)
    assert ([(r.round, r.vehicle, r.time) for r in ser.rounds]
            == [(r.round, r.vehicle, r.time) for r in bat.rounds])
    for k in ser.final_params:
        torch.testing.assert_close(bat.final_params[k], ser.final_params[k],
                                   rtol=1e-4, atol=1e-5)


def test_run_scenario_trace_matches_repro():
    """``run_scenario`` plumbing: the port's own init, the same host trace
    as ``repro.run_scenario`` on the auto-selected engine."""
    tres = tsc.run_scenario("quick-k5", rounds=3, eval_every=3,
                            use_kernel=True, device="cpu")
    jres = jsc.run_scenario("quick-k5", rounds=3, eval_every=3,
                            use_kernel=True)
    assert ([(r.round, r.vehicle, r.time) for r in tres.rounds]
            == [(r.round, r.vehicle, r.time) for r in jres.rounds])
    assert tres.report is None and len(tres.acc_history) == 1
