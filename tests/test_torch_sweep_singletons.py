"""The sweep engine's singleton timeline groups on the CPU under the bf16
ring: each world is alone in its group, so it is bitwise its solo
``engine="jit"`` run in the port, and one ``ring_agg`` call serves all
worlds per union chain end.  Per-world channel scalars are in
``tests/test_torch_sweep_selection.py``."""
from __future__ import annotations

import dataclasses

import pytest

import repro_torch.core.scenarios as tsc
from _torch_sweep import assert_singletons_are_solo
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("case", ["bf16 ring"])
def test_singleton_worlds_are_their_solo_runs(case, monkeypatch):
    """Two seeds with the bf16 ring (uploads and stored rows in bf16
    around the f32 masters)."""
    base = dataclasses.replace(tsc.get_scenario("quick-k5"), rounds=8,
                               ring_dtype="bf16")
    assert_singletons_are_solo([(base, s) for s in (0, 1)], monkeypatch)
