"""The corridor's serial handover loop (``engine="serial"``) on the CPU
against ``repro``'s, from the same (JAX-drawn) init with the kernel path
on: the host engines' bands (``_torch_world.py``: identical (round,
vehicle, rsu) trace, times and weights to rtol 1e-9, ``PARAM_TOL``,
accuracy 0.02); and the port's two corridor engines against each other,
to ``repro``'s own bands for that pair (``tests/test_engine_conformance.
py``: params atol 2e-3 with the real CNN, accuracy 0.05).  Shared worlds
and runs: ``tests/_torch_corridor.py``."""
from __future__ import annotations

import numpy as np

from _torch_corridor import (  # noqa: F401
    ENGINE_VS_SERIAL, ENGINE_VS_SERIAL_ACC, QUICK, _assert_acc,
    _assert_params, _pair, _port, _trace, init)
from _torch_world import (ACC_TOL, FLEET_TIME_TOL, FLEET_WEIGHT_TOL,
                          PARAM_TOL)
import pytest
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_serial_matches_repro_serial(init):
    jres, tres = _pair(QUICK, "serial", init, 3, rounds=6)
    assert tres.scheme == jres.scheme == "mafl+handover"
    assert _trace(tres) == _trace(jres)
    for a, b in zip(jres.rounds, tres.rounds):
        np.testing.assert_allclose(
            [b.time, b.upload_delay, b.train_delay, b.weight],
            [a.time, a.upload_delay, a.train_delay, a.weight], rtol=1e-9)
    _assert_params(jres.final_params, tres.final_params, PARAM_TOL)
    _assert_acc(jres.acc_history, tres.acc_history, ACC_TOL)


def test_engine_matches_serial_in_the_port(init):
    ser = _port(QUICK, "serial", init, rounds=6, eval_every=3)
    eng = _port(QUICK, "corridor", init, rounds=6, eval_every=3)
    assert _trace(eng) == _trace(ser)
    np.testing.assert_allclose([r.time for r in eng.rounds],
                               [r.time for r in ser.rounds], **FLEET_TIME_TOL)
    np.testing.assert_allclose([r.weight for r in eng.rounds],
                               [r.weight for r in ser.rounds],
                               **FLEET_WEIGHT_TOL)
    for k in ser.final_params:
        np.testing.assert_allclose(eng.final_params[k].numpy(),
                                   ser.final_params[k].numpy(), err_msg=k,
                                   **ENGINE_VS_SERIAL)
    _assert_acc(ser.acc_history, eng.acc_history, ENGINE_VS_SERIAL_ACC)
