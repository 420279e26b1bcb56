"""The corridor's device engine keeps every ring row a wave reads bitwise
as it was stored (the cohort stack is written in place at every chain
end), with the EMA reconcile and under eps-bandit selection, and those
runs match ``repro``'s to the fleet engine's f32 bands.  Shared worlds and
runs: ``tests/_torch_corridor.py``."""
from __future__ import annotations

import torch

import repro.core.scenarios as jsc
import repro_torch.corridor.engine as tengine
from _torch_corridor import (  # noqa: F401
    QUICK, _assert_engine_conforms, _port, init)
import pytest
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _ring_reads(init, monkeypatch, kw):
    """Run corridor-quick-r2-k8 with ``kw`` on the port's corridor engine,
    checking that each ring row a wave reads is bitwise the row as it was
    stored, and that no row changes after the reads either (later chains
    and reconciles write the stack in place).  Returns the rows read and
    the run."""
    stored, reads, rings = {}, [], []
    real_seg, real_wave = tengine._chain_segment, tengine._train_wave

    def snap(ring):
        for r, row in ring.items():
            if r not in stored or stored[r][0] is not row:
                stored[r] = (row, row.clone())

    def seg(queue, G, locals_buf, ring, *a, **kw):
        rings.append(ring)
        snap(ring)
        out = real_seg(queue, G, locals_buf, ring, *a, **kw)
        snap(ring)
        return out

    def wave(rows, pay_rounds, *a, **kw):
        snap(rows)
        for pr in pay_rounds:
            reads.append(int(pr))
            assert torch.equal(rows[int(pr)], stored[int(pr)][1]), pr
        return real_wave(rows, pay_rounds, *a, **kw)

    monkeypatch.setattr(tengine, "_chain_segment", seg)
    monkeypatch.setattr(tengine, "_train_wave", wave)
    res = _port(QUICK, "corridor", init, eval_every=4, **kw)
    ring = rings[-1]
    assert all(stored[r][0] is row and torch.equal(row, stored[r][1])
               for r, row in ring.items())
    return set(reads), res


def test_ring_rows_stay_as_stored_and_match_repro(init, monkeypatch):
    """corridor-quick-r2-k8 for 16 rounds with the EMA reconcile: later
    waves read ring rows stored by chains on both RSUs and by the
    reconcile at round 4, while the cohort stack is written in place at
    every chain end.  Each row a wave reads is bitwise the row as it was
    stored, and stays so to the end of the run; the run matches
    ``repro``'s."""
    kw = dict(rounds=16, reconcile_mode="ema", reconcile_tau=0.3)
    reads, res = _ring_reads(init, monkeypatch, kw)
    # rows of both RSUs' chains (5 and 6 follow uploads to RSU 1) and the
    # reconciled row of round 4
    assert {1, 2, 3, 4, 5, 6, 10, 11} <= reads
    jres = jsc.run_scenario(QUICK, engine="corridor", eval_every=4,
                            use_kernel=True, **kw)
    _assert_engine_conforms(jres, res)


def test_ring_rows_stay_as_stored_on_a_selection_world(init, monkeypatch):
    """The same on a FedAvg world with eps-bandit selection: a vehicle
    re-admitted at reconcile round b reads ring row b (in f32 the stored
    row is the tensor itself), and the run matches ``repro``'s."""
    kw = dict(rounds=16, selection="eps-bandit", selection_k=2,
              selection_eps=0.4)
    reads, res = _ring_reads(init, monkeypatch, kw)
    decisions = res.report.selection["decisions"]
    assert {b for b, newly, _ in decisions if newly} & reads
    jres = jsc.run_scenario(QUICK, engine="corridor", eval_every=4,
                            use_kernel=True, **kw)
    _assert_engine_conforms(jres, res)
    assert res.report.selection == jres.report.selection
