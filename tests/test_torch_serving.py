"""The port's continuous-batching server against ``repro``'s on the same
requests and weights (token lists must be identical), ``repro``'s own
server cases run on the port, and a smoke run of the ``serve`` CLI."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_world import transformer_pair
from repro.serving import BatchedServer as JServer
from repro_torch.launch import serve
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedServer


@pytest.fixture(scope="module")
def served():
    return transformer_pair()


def _requests(cfg):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((5, 6), (9, 4), (3, 7))]


def test_server_tokens_equal_repro(served):
    """3 requests over 2 slots: the third claims the slot the second frees
    (its cache row is rewritten); every token list equals repro's."""
    jcfg, jparams, tcfg, model = served
    jsrv = JServer(jcfg, jparams, n_slots=2, max_seq=32)
    tsrv = BatchedServer(tcfg, model, n_slots=2, max_seq=32)
    jreqs = [jsrv.submit(p, m) for p, m in _requests(jcfg)]
    treqs = [tsrv.submit(p, m) for p, m in _requests(tcfg)]
    jticks = jsrv.run_until_drained(max_ticks=100)
    tticks = tsrv.run_until_drained(max_ticks=100)
    assert tticks == jticks
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done and len(r.out) == m
               for r, (_, m) in zip(treqs, _requests(tcfg)))


def test_server_drains_requests(served):
    _, _, cfg, model = served
    srv = BatchedServer(cfg, model, n_slots=2, max_seq=32)
    reqs = [srv.submit(np.arange(4) + i, max_new=5) for i in range(3)]
    ticks = srv.run_until_drained(max_ticks=100)
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 5 for r in reqs)
    assert ticks < 100
    # 3 requests over 2 slots => the third admits after a slot frees
    assert srv.pending() == 0 and srv.active() == 0


def test_server_matches_unbatched_decode(served):
    """Slot-pooled decode equals a dedicated single-sequence decode."""
    _, _, cfg, model = served
    prompt = np.arange(6, dtype=np.int32)
    srv = BatchedServer(cfg, model, n_slots=2, max_seq=32)
    r = srv.submit(prompt, max_new=4)
    # occupy the other slot with a different request to prove isolation
    srv.submit(np.arange(3, dtype=np.int32) + 7, max_new=6)
    srv.run_until_drained()

    logits, cache = tT.prefill(cfg, model, torch.from_numpy(prompt[None]))
    cache = tT.grow_cache(cfg, cache, 1, 32)
    tok = int(torch.argmax(logits[0, -1]))
    expect = [tok]
    pos = len(prompt)
    for _ in range(3):
        lg, cache = tT.decode_step(cfg, model, torch.tensor([[tok]]),
                                   cache, pos)
        tok = int(torch.argmax(lg[0, 0]))
        expect.append(tok)
        pos += 1
    assert r.out == expect


def test_server_eos_frees_slot(served):
    """With one slot, the first request's EOS frees it for the second."""
    _, _, cfg, model = served
    probe = BatchedServer(cfg, model, n_slots=1, max_seq=32)
    first = probe.submit(np.arange(4, dtype=np.int32), max_new=8)
    probe.run_until_drained()
    eos = first.out[1]
    srv = BatchedServer(cfg, model, n_slots=1, max_seq=32, eos_id=eos)
    r1 = srv.submit(np.arange(4, dtype=np.int32), max_new=8)
    r2 = srv.submit(np.arange(4, dtype=np.int32) + 2, max_new=3)
    srv.run_until_drained()
    assert r1.done and r2.done
    assert r1.out == first.out[:2]           # stopped at the EOS token
    assert srv.active() == 0 and srv.pending() == 0


def test_serve_cli_runs_on_cpu(capsys):
    toks = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "5"])
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    assert "decoded 4 steps x 2 seqs" in capsys.readouterr().out
