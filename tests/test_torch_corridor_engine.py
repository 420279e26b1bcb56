"""The corridor's device engine (``engine="corridor"``) on the CPU against
``repro``'s, from the same (JAX-drawn) init with the kernel path on (the
port's wrappers take their plain versions on CPU tensors; ``repro``'s run
the Pallas kernels in interpret mode): the fleet engine's f32 bands
(``FLEET_TIME_TOL``, ``FLEET_WEIGHT_TOL``, ``PARAM_TOL``,
``BF16_PARAM_TOL`` with a bf16 ring), on corridor-quick-r2-k8 under each
scheme and reconcile and on the highway.  Shared worlds and runs:
``tests/_torch_corridor.py``."""
from __future__ import annotations

import pytest

from _torch_corridor import (  # noqa: F401
    QUICK, _assert_engine_conforms, _pair, init)
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("kw", [
    {},
    {"reconcile_mode": "ema", "reconcile_tau": 0.3},
    {"scheme": "afl"},
    {"scheme": "fedasync"},
    {"ring_dtype": "bf16"},
], ids=["fedavg", "ema", "afl", "fedasync", "bf16"])
def test_engine_matches_repro_engine(init, kw):
    jres, tres = _pair(QUICK, "corridor", init, 4, rounds=8, **kw)
    _assert_engine_conforms(jres, tres, bf16=kw.get("ring_dtype") == "bf16")


def test_engine_matches_repro_engine_on_the_highway(init):
    """highway-k40-handover cut to 12 rounds, one local step: handover
    across the four RSUs, a reconcile at round 8."""
    jres, tres = _pair("highway-k40-handover", "corridor", init, 6,
                       rounds=12, l_iters=1)
    assert len({r.rsu for r in tres.rounds}) > 1
    _assert_engine_conforms(jres, tres)
