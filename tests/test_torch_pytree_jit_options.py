"""The fleet engine's pytree program against the port's own flat program
on the CPU under every option it takes (no JAX compile): bands
``_torch_engines.assert_pytree_is_flat``'s."""
from __future__ import annotations

import pytest

from _torch_engines import (CAPPED, assert_pytree_is_flat,  # noqa: F401
                            fleet_run)
from _torch_threads import one_thread  # noqa: F401
from repro_torch.selection import SelectionSpec

pytestmark = pytest.mark.usefixtures("one_thread")

OPTIONS = {
    "mafl": {},
    "afl": dict(scheme="afl"),
    "fedasync": dict(scheme="fedasync"),
    "literal": dict(interpretation="literal"),
    "kernel": dict(use_kernel=True),
    "kernel-literal": dict(use_kernel=True, interpretation="literal"),
    "eps-bandit": dict(selection=SelectionSpec(policy="eps-bandit", k=3,
                                               eps=0.3, resel_every=4)),
    "heavy-faults": dict(faults=CAPPED, l_iters=3),
    "metrics": dict(metrics="on"),
    "metrics-heavy-kernel": dict(metrics="on", use_kernel=True,
                                 faults=CAPPED, l_iters=3),
}


# the flat program ignores ``use_kernel`` (every merge is a K1 chain), so
# options that differ only in it share one flat run
_FLAT: dict = {}


def _flat_run(kw):
    key = repr(sorted((k, v) for k, v in kw.items() if k != "use_kernel"))
    if key not in _FLAT:
        _FLAT[key] = fleet_run("quick-k5", True, **dict(kw))
    return _FLAT[key]


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_pytree_jit_is_the_flat_program(opt):
    """quick-k5 for 12 rounds on both programs of the port: bitwise
    without the kernel (every product and sum of a merge rounds alone on
    both), within PARAM_TOL with it; the same trace, selection and fault
    summaries and telemetry channels either way."""
    kw = dict(OPTIONS[opt], rounds=12)
    flat = _flat_run(kw)
    tree = fleet_run("quick-k5", False, **dict(kw))
    assert tree.report.engine == "jit" and len(tree.rounds) == 12
    assert_pytree_is_flat(flat, tree, bitwise="use_kernel" not in kw)
