"""The port's decoder LM against ``repro``'s on smollm-360m reduced (G = 4)
and a variant with 6 query and 2 KV heads (the full model's G = 3), with
``repro``'s ``T.init_params`` weights and the same numpy tokens.

Tolerances: logits atol 1e-4 / rtol 1e-4 and caches atol 1e-5 — both sides
run f32 on the CPU; the matrix products sum in different orders, a few
ulps per layer on activations of size ~1-10."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_world import transformer_pair
from repro.models import transformer as jT
from repro_torch.convert import transformer_params_to_numpy
from repro_torch.models import transformer as tT
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=0)
VARIANTS = {"reduced": None, "G3": dict(n_heads=6, n_kv_heads=2)}
B, PROMPT, MAX_SEQ, STEPS = 2, 12, 32, 8


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return transformer_pair(VARIANTS[request.param])


def _leaves(cache):
    return {f"{name}.{k}": v for name, sub in cache["stack"].items()
            for k, v in sub["mixer"].items()}


def _assert_caches(tcache, jcache):
    t, j = _leaves(tcache), _leaves(jcache)
    assert set(t) == set(j)
    for k in j:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   err_msg=k, **CACHE_TOL)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_weights_round_trip(pair):
    jcfg, jparams, tcfg, model = pair
    back = transformer_params_to_numpy(model)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tT.param_count(tcfg) == jT.param_count(jcfg)


def test_prefill_logits_and_cache(pair):
    jcfg, jparams, tcfg, model = pair
    tokens = _tokens(tcfg, (B, PROMPT), 0)
    jlogits, jcache = jT.prefill(jcfg, jparams, jnp.asarray(tokens))
    tlogits, tcache = tT.prefill(tcfg, model, torch.from_numpy(tokens))
    assert tlogits.shape == (B, PROMPT, tcfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    _assert_caches(tcache, jcache)


def test_cache_shapes(pair):
    jcfg, _, tcfg, model = pair
    tokens = _tokens(tcfg, (B, PROMPT), 1)
    _, tcache = tT.prefill(tcfg, model, torch.from_numpy(tokens))
    grown = tT.grow_cache(tcfg, tcache, B, MAX_SEQ)
    want = jax.eval_shape(lambda: jT.init_cache(jcfg, B, MAX_SEQ))
    fresh = tT.init_cache(tcfg, B, MAX_SEQ, device="cpu")
    for c in (grown, fresh):
        got = {k: tuple(v.shape) for k, v in _leaves(c).items()}
        assert got == {k: tuple(v.shape) for k, v in _leaves(want).items()}
    for k, v in _leaves(grown).items():
        assert not v[:, :, PROMPT:].any(), k
        assert torch.equal(v[:, :, :PROMPT], _leaves(tcache)[k])
    assert not any(v.any() for v in _leaves(fresh).values())


@pytest.mark.parametrize("per_seq", [False, True], ids=["scalar", "vector"])
def test_teacher_forced_decode(pair, per_seq):
    """Eight decode steps fed the same tokens on both sides: the logits of
    every step and the cache after each."""
    jcfg, jparams, tcfg, model = pair
    prompt = _tokens(tcfg, (B, PROMPT), 2)
    forced = _tokens(tcfg, (STEPS, B, 1), 3)
    _, jcache = jT.prefill(jcfg, jparams, jnp.asarray(prompt))
    jcache = jT.grow_cache(jcfg, jcache, B, MAX_SEQ)
    _, tcache = tT.prefill(tcfg, model, torch.from_numpy(prompt))
    tcache = tT.grow_cache(tcfg, tcache, B, MAX_SEQ)
    jstep = jax.jit(functools.partial(jT.decode_step, jcfg))
    # per sequence: the rows sit at different positions (row 1 rewrites
    # prompt entries from 9 on)
    start = np.array([PROMPT, 9], np.int32)
    for i in range(STEPS):
        pos = start + i if per_seq else np.int32(PROMPT + i)
        jlogits, jcache = jstep(jparams, jnp.asarray(forced[i]), jcache,
                                jnp.asarray(pos))
        tpos = torch.from_numpy(pos) if per_seq else int(pos)
        tlogits, tcache = tT.decode_step(tcfg, model,
                                         torch.from_numpy(forced[i]),
                                         tcache, tpos)
        assert tlogits.shape == (B, 1, tcfg.vocab_size)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **LOGIT_TOL)
        _assert_caches(tcache, jcache)


def test_unported_layers_raise():
    """Nothing of item 12 raises any more: MoE MLPs, MLA mixers and
    ``first_k_dense`` prefixes (part 3), Mamba mixers and LayerNorm stacks
    of RWKV sublayers (part 4) build and run; the checkpoint policies run
    and give ``full``'s logits bitwise."""
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m").reduced()
    tokens = torch.zeros(1, 4, dtype=torch.int64)
    for ok in (dict(moe_every=1, n_routed_experts=4, moe_top_k=2,
                    moe_d_ff=64),
               dict(use_mla=True, kv_lora_rank=32, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16),
               dict(first_k_dense=1, n_layers=3), dict(attn_every=2),
               dict(family="ssm", rwkv_head_size=32)):
        c = cfg.variant(**ok)
        m = tT.init_params(c, torch.Generator().manual_seed(0), device="cpu")
        logits, _ = tT.forward(c, m, tokens)
        assert logits.shape == (1, 4, c.vocab_size)
        assert torch.isfinite(logits).all()
    model = tT.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    want, _ = tT.forward(cfg, model, tokens)
    for policy in (dict(remat_policy="dots"), dict(remat_sublayer=True)):
        got, _ = tT.forward(cfg.variant(**policy), model, tokens)
        assert torch.equal(got, want)
