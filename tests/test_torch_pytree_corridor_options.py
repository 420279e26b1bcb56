"""The corridor engine's pytree program against the port's own flat
program on the CPU under every option it takes (no JAX compile): bands
``_torch_engines.assert_pytree_is_flat``'s."""
from __future__ import annotations

import pytest

from _torch_engines import (HEAVY, QUICK, assert_pytree_is_flat,  # noqa: F401
                            corridor_run)
from _torch_threads import one_thread  # noqa: F401
from repro_torch.faults import FaultSpec
from repro_torch.selection import SelectionSpec

pytestmark = pytest.mark.usefixtures("one_thread")

OPTIONS = {
    "fedavg": {},
    "kernel": dict(use_kernel=True),
    "ema": dict(reconcile_mode="ema", reconcile_tau=0.3),
    "ema-kernel": dict(reconcile_mode="ema", reconcile_tau=0.3,
                       use_kernel=True),
    "fedasync": dict(scheme="fedasync"),
    "literal-kernel": dict(interpretation="literal", use_kernel=True),
    "eps-bandit": dict(selection=SelectionSpec(policy="eps-bandit", k=2,
                                               eps=0.4)),
    "heavy-faults": dict(faults=FaultSpec(**HEAVY), l_iters=2),
    "metrics-heavy": dict(metrics="on", faults=FaultSpec(**HEAVY),
                          l_iters=2),
}


# the flat program reads ``use_kernel`` only in the EMA reconcile (every
# arrival is a K1 chain), so FedAvg options that differ only in it share
# one flat run
_FLAT: dict = {}


def _flat_run(kw):
    key = repr(sorted((k, v) for k, v in kw.items()
                      if k != "use_kernel"
                      or kw.get("reconcile_mode") == "ema"))
    if key not in _FLAT:
        _FLAT[key] = corridor_run(QUICK, True, **dict(kw))
    return _FLAT[key]


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_pytree_corridor_is_the_flat_program(opt):
    """corridor-quick-r2-k8 for 16 rounds on both programs of the port,
    with ``record_cohorts``: bitwise without the kernel (per-arrival
    merges and the chains round alike; the reconciles are the same per-leaf
    ops), within PARAM_TOL with it; the same trace, summaries and
    channels either way."""
    kw = dict(OPTIONS[opt], rounds=16, record_cohorts=True)
    flat = _flat_run(kw)
    tree = corridor_run(QUICK, False, **dict(kw))
    assert tree.report.engine == "corridor" and len(tree.rounds) == 16
    assert len(tree.extras["cohort_snapshots"]) == 4
    assert_pytree_is_flat(flat, tree, bitwise="use_kernel" not in kw)
