"""Serving the dense-attention architectures in the port against ``repro``
on the same numpy weights, tokens and patch embeddings: prefill logits and
caches (ring leaves in ``repro``'s slot order), then teacher-forced decode
steps at scalar positions, the logits of every step and the cache after
the last; ``BatchedServer`` on the two archs it serves (qwen1.5-4b,
musicgen-large) with token lists equal to ``repro``'s server; and
``launch/serve.py:generate`` with the tokens of ``repro``'s greedy loop.

Prompts of 40 tokens (under the window of 64: the ring starts padded, and
32 decode steps carry it past the window so it wraps; for the chunked
variant its decode crosses into the second chunk, where slot 0 is reset
and pos' is 0) and 80 (a wrapped ring; for the chunked variant a prompt
that ends inside its second chunk, S % C != 0, whose 32 steps, positions
80-111, stay in that chunk).  Tolerances are ``_torch_archs.py``'s."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_archs import (CASES, LOGIT_TOL, arch_pair, as_jax, as_torch,
                          assert_caches, frontend, jax_decode, jax_prefill,
                          tokens)
from _torch_threads import one_thread  # noqa: F401
from repro.models import transformer as jT
from repro.serving import BatchedServer as JServer
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedServer

pytestmark = pytest.mark.usefixtures("one_thread")

B, STEPS = 2, 32
PROMPTS = (40, 80)


def _prefill_both(case, P):
    jcfg, jparams, tcfg, model = arch_pair(case)
    prompt = tokens(tcfg, (B, P), P)
    fe = frontend(tcfg, B, P)
    jout = jax_prefill(case)(jparams, jnp.asarray(prompt), as_jax(fe))
    tout = tT.prefill(tcfg, model, torch.from_numpy(prompt), as_torch(fe))
    return jout, tout


@pytest.mark.parametrize("P", PROMPTS)
@pytest.mark.parametrize("case", CASES)
def test_prefill_logits_and_cache(case, P):
    (jlogits, jcache), (tlogits, tcache) = _prefill_both(case, P)
    tcfg = arch_pair(case)[2]
    n_front = tcfg.n_frontend_tokens if tcfg.frontend == "vision" else 0
    assert tlogits.shape == (B, n_front + P, tcfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    assert_caches(tcache, jcache, "prefill")


@pytest.mark.parametrize("P", PROMPTS)
@pytest.mark.parametrize("case", CASES)
def test_teacher_forced_decode(case, P):
    """32 steps fed the same tokens on both sides at scalar positions
    after the prompt (and after the patch embeddings)."""
    jcfg, jparams, tcfg, model = arch_pair(case)
    (_, jcache), (_, tcache) = _prefill_both(case, P)
    start = P + (tcfg.n_frontend_tokens if tcfg.frontend == "vision" else 0)
    max_seq = start + STEPS
    jcache = jT.grow_cache(jcfg, jcache, B, max_seq)
    tcache = tT.grow_cache(tcfg, tcache, B, max_seq)
    forced = tokens(tcfg, (STEPS, B, 1), 1000 + P)
    step = jax_decode(case)
    for i in range(STEPS):
        jlogits, jcache = step(jparams, jnp.asarray(forced[i]), jcache,
                               jnp.int32(start + i))
        tlogits, tcache = tT.decode_step(tcfg, model,
                                         torch.from_numpy(forced[i]),
                                         tcache, start + i)
        assert tlogits.shape == (B, 1, tcfg.vocab_size)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **LOGIT_TOL)
    assert_caches(tcache, jcache, f"after {STEPS} steps")


@pytest.mark.parametrize("case", ["qwen", "musicgen"])
def test_server_tokens_equal_repro(case):
    """3 requests over 2 slots (the third takes the slot the second
    frees): every token list equals ``repro``'s server's."""
    jcfg, jparams, tcfg, model = arch_pair(case)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, tcfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((5, 6), (9, 4), (3, 7))]
    jsrv = JServer(jcfg, jparams, n_slots=2, max_seq=32)
    tsrv = BatchedServer(tcfg, model, n_slots=2, max_seq=32)
    jreqs = [jsrv.submit(p, m) for p, m in reqs]
    treqs = [tsrv.submit(p, m) for p, m in reqs]
    assert tsrv.run_until_drained(100) == jsrv.run_until_drained(100)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done and len(r.out) == m for r, (_, m) in zip(treqs, reqs))


@pytest.mark.parametrize("case", ["swa", "internvl2"])
def test_generate_tokens_equal_repro_greedy_loop(case):
    """``launch/serve.py:generate`` (16-token prompts, 8 tokens: a ring
    that never fills its window of 64, or patch embeddings first) gives
    the tokens of ``repro``'s greedy prefill-and-decode loop, whose cache
    is grown to the window (``repro``'s pad fails below it)."""
    from repro_torch.launch.serve import generate
    jcfg, jparams, tcfg, model = arch_pair(case)
    prompt = tokens(tcfg, (B, 16), 3)
    fe = frontend(tcfg, B, 3)
    offset = 0 if fe is None else tcfg.n_frontend_tokens
    got, _, _ = generate(tcfg, model, torch.from_numpy(prompt), 8,
                         as_torch(fe))
    logits, cache = jax_prefill(case)(jparams, jnp.asarray(prompt),
                                      as_jax(fe))
    cache = jT.grow_cache(jcfg, cache, B, max(offset + 16 + 8,
                                              jcfg.sliding_window or 0))
    token = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    want = [np.asarray(token)]
    for i in range(7):
        logits, cache = jax_decode(case)(jparams, token, cache,
                                         jnp.int32(offset + 16 + i))
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(token))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))
