"""Shared by the port's corridor tests (``test_torch_corridor*.py``, split
by engine group): the worlds, one port run and a run pair against
``repro`` from one (JAX-drawn) init with the kernel path on, and the
comparisons.  Tolerances are ``_torch_world.py``'s; the pair of the
port's two corridor engines is held to ``repro``'s own band for that pair
(``tests/test_engine_conformance.py``: params atol 2e-3 with the real
CNN, accuracy 0.05).  A fixture imported from here into a test module is
that module's fixture."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core.scenarios as jsc
import repro_torch.core.scenarios as tsc
from _torch_world import (ACC_TOL, BF16_PARAM_TOL, FLEET_TIME_TOL,
                          FLEET_WEIGHT_TOL, PARAM_TOL, jax_init)
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.corridor import (run_corridor_simulation,
                                  run_handover_simulation)

QUICK = "corridor-quick-r2-k8"
ENGINE_VS_SERIAL = dict(rtol=0.0, atol=2e-3)
ENGINE_VS_SERIAL_ACC = 0.05


@pytest.fixture(scope="module")
def init():
    return jax_init()


def _port(name, engine, init, use_kernel=True, **overrides):
    """One port run from ``repro``'s init, on the CPU."""
    eval_every = overrides.pop("eval_every")
    sc = dataclasses.replace(tsc.get_scenario(name), **overrides)
    veh, ti, tl, p = tsc.build_world(sc)
    run = (run_handover_simulation if engine == "serial"
           else run_corridor_simulation)
    return run(sc, veh, ti, tl, p, eval_every=eval_every,
               use_kernel=use_kernel,
               init_params=params_from_jax(init, "cpu"), device="cpu")


def _pair(name, engine, init, eval_every, **overrides):
    jres = jsc.run_scenario(name, engine=engine, eval_every=eval_every,
                            use_kernel=True, **overrides)
    sc = dataclasses.replace(tsc.get_scenario(name), **overrides)
    veh, ti, tl, p = tsc.build_world(sc)
    run = (run_handover_simulation if engine == "serial"
           else run_corridor_simulation)
    tres = run(sc, veh, ti, tl, p, eval_every=eval_every, use_kernel=True,
               init_params=params_from_jax(init, "cpu"), device="cpu")
    assert len(tres.rounds) == sc.rounds
    assert ([getattr(tres.report, f) for f in ("engine", "scheme", "rounds")]
            == [getattr(jres.report, f) for f in ("engine", "scheme",
                                                  "rounds")])
    return jres, tres


def _trace(res):
    return [(r.round, r.vehicle, r.rsu) for r in res.rounds]


def _assert_params(jparams, tparams, tol):
    tnp = params_to_numpy(tparams)
    for k, v in jparams.items():
        assert tparams[k].device.type == "cpu"
        np.testing.assert_allclose(tnp[k], np.asarray(v), err_msg=k, **tol)


def _assert_acc(a_hist, b_hist, tol):
    assert [r for r, _ in a_hist] == [r for r, _ in b_hist]
    for (_, a), (_, b) in zip(a_hist, b_hist):
        assert abs(a - b) <= tol and np.isfinite(b)


def _assert_engine_conforms(jres, tres, bf16=False):
    assert tres.scheme == jres.scheme
    assert _trace(tres) == _trace(jres)
    for a, b in zip(jres.rounds, tres.rounds):
        np.testing.assert_allclose(
            [b.time, b.upload_delay, b.train_delay],
            [a.time, a.upload_delay, a.train_delay], **FLEET_TIME_TOL)
        np.testing.assert_allclose(b.weight, a.weight, **FLEET_WEIGHT_TOL)
    tol = BF16_PARAM_TOL if bf16 else PARAM_TOL
    _assert_params(jres.final_params, tres.final_params, tol)
    # the [R, ...] cohort stack at the end, row for row
    jG, tG = jres.extras["final_cohorts"], tres.extras["final_cohorts"]
    _assert_params(jG, tG, tol)
    np.testing.assert_array_equal(tres.extras["up_rsu"],
                                  jres.extras["up_rsu"])
    assert tres.extras["eval_rounds"] == jres.extras["eval_rounds"]
    assert tres.extras["n_rsus"] == jres.extras["n_rsus"]
    _assert_acc(jres.acc_history, tres.acc_history, ACC_TOL)
