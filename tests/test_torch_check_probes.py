"""The port's run probes: PLN003 (``repro_torch.check.plan_shapes``) with
``plan_fleet``'s signature held to ``repro``'s field for field, and the
dtype-flow check (``repro_torch.check.dtype_flow``) on the fleet engine's
f32 and bf16 rings plus synthetic bf16 arithmetic.  ``repro``'s own
dtype-flow probe is not called here: it stages jaxprs through
``jax.core.ClosedJaxpr``, which newer jax releases removed."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.channel.params import ChannelParams as JChannelParams
from repro.check.plan_shapes import _signature as jsignature
from repro.core.jit_engine import plan_fleet as jplan_fleet
from repro_torch.channel import ChannelParams
from repro_torch.check import dtype_flow, plan_shapes
from repro_torch.check.dtype_flow import OpRecorder, check_ops
from repro_torch.core.jit_engine import plan_fleet
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_plan_shapes_probe_clean():
    assert [f.format() for f in plan_shapes.probe_plan_shapes()] == []


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_fleet_signature_equals_repro(seed):
    mine = plan_shapes._signature(plan_fleet(
        dataclasses.replace(ChannelParams(), K=5), seed=seed, rounds=12))
    ref = jsignature(jplan_fleet(
        dataclasses.replace(JChannelParams(), K=5), seed=seed, rounds=12))
    assert mine == ref


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_corridor_signature_equals_repro(seed):
    """The corridor probe's two signatures, plan fields and padded
    tables, field for field against ``repro.check``'s."""
    import repro.core  # noqa: F401  (repro.corridor imports through it)
    from repro.check.plan_shapes import _tables_signature as jtables
    from repro.corridor.plan import plan_corridor as jplan_corridor
    from repro_torch.corridor.plan import plan_corridor

    mine = plan_corridor(dataclasses.replace(ChannelParams(), K=5),
                         n_rsus=2, seed=seed, rounds=12)
    ref = jplan_corridor(dataclasses.replace(JChannelParams(), K=5),
                         n_rsus=2, seed=seed, rounds=12)
    assert plan_shapes._signature(mine) == jsignature(ref)
    assert (plan_shapes._tables_signature(mine.tables())
            == jtables(ref.tables()))


def test_plan_shapes_flags_a_seed_dependent_field():
    sigs = {0: {"veh": ((12,), "int32")}, 1: {"veh": ((11,), "int32")}}
    out = []
    plan_shapes._diff("plan_fleet", sigs, out, "<probe:plan_fleet>")
    assert [f.rule for f in out] == ["PLN003"]


@pytest.mark.parametrize("ring", ["f32", "bf16"])
def test_dtype_flow_clean_on_fleet_engine(ring):
    assert [f.format() for f in dtype_flow._jit_probe(ring)] == []


def _record(fn, *args):
    with OpRecorder() as rec:
        fn(*args)
    return rec


def test_dtype_flow_flags_bf16_compute():
    x = torch.ones(4, 4, dtype=torch.bfloat16)
    rec = _record(lambda a, b: ((a @ b).float(), a + a), x, x)
    rules = {f.rule for f in check_ops(rec, allow_bf16=True, path="<t>")}
    assert rules == {"DTF001", "DTF002"}
    rules = {f.rule for f in check_ops(rec, allow_bf16=False, path="<t>")}
    assert rules == {"DTF003"}


def test_dtype_flow_allows_bf16_storage_roles():
    x = torch.ones(4, 4, dtype=torch.bfloat16)

    def ok(a, b):
        wide = a.float() @ b.float()
        buf = torch.zeros(2, 16, dtype=torch.bfloat16)
        buf.index_copy_(0, torch.tensor([1]), wide.to(torch.bfloat16)
                        .reshape(1, -1))
        return torch.cat([buf, buf]).index_select(0, torch.tensor([1]))[0]
    rec = _record(ok, x, x)
    assert rec.bf16_ops
    assert check_ops(rec, allow_bf16=True, path="<t>") == []
