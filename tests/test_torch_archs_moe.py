"""The MoE + MLA architectures through the port's entry points against
``repro``'s on the same weights (the port's seeded init, as numpy) and
tokens: reduced
deepseek-v2-lite-16b (a dense MLA prefix layer, then MLA + MoE, 4 experts
top-2 with a shared one) and reduced llama4-scout-17b-a16e (periods of
[chunked, global] attention, each with a top-1 MoE and a shared expert):
logits and the summed aux loss, greedy ``generate`` tokens over 8 steps,
``BatchedServer`` tokens, one ``make_train_step``, the checkpoint round
trip with ``repro``'s ``prefix`` list, and the full-size ``param_count``.

Tolerances are ``tests/_torch_archs.py``'s and ``test_torch_archs_train.py``'s:
logits atol 1e-4 / rtol 1e-4, aux and losses rtol 1e-5, parameters after
one SGD step atol 1e-6 / rtol 1e-5; tokens and checkpoints exact."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_archs import LOGIT_TOL, tokens
from _torch_threads import one_thread  # noqa: F401
from repro.checkpointing import checkpoint as jck
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import transformer as jT
from repro.serving import BatchedServer as JServer
from repro_torch.checkpointing import checkpoint as tck
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import (transformer_params_from_jax,
                                 transformer_params_to_numpy)
from repro_torch.launch import steps as tsteps
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedServer

pytestmark = pytest.mark.usefixtures("one_thread")

AUX_TOL = dict(atol=0, rtol=1e-5)
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
LR = 0.05
ARCHS = {"deepseek": "deepseek-v2-lite-16b", "scout": "llama4-scout-17b-a16e"}


@functools.lru_cache(maxsize=None)
def pair(case, **overrides):
    """(repro cfg, repro params, port cfg, port model on the CPU): the
    port's init from a seed, handed to ``repro`` as numpy (``repro``'s
    own init runs op by op here, 5-11 s a config)."""
    jcfg = jget_config(ARCHS[case]).reduced().variant(**overrides)
    tcfg = tget_config(ARCHS[case]).reduced().variant(**overrides)
    model = tT.init_params(tcfg, torch.Generator().manual_seed(1),
                           device="cpu")
    tree = transformer_params_to_numpy(model)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg, model


def _leaves(tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        yield tuple(getattr(p, "key", getattr(p, "idx", None))
                    for p in path), leaf


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("case", list(ARCHS))
def test_logits_and_aux(case):
    """S 80: past scout's chunk of 64 (two chunks, one of them partial)."""
    jcfg, jparams, tcfg, model = pair(case)
    toks = tokens(tcfg, (2, 80), 4)
    jl, jaux = jax.jit(functools.partial(jT.forward, jcfg))(
        jparams, jnp.asarray(toks))
    tl, taux = tT.forward(tcfg, model, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


@pytest.mark.parametrize("case", list(ARCHS))
def test_generate_tokens_equal_repro_greedy_loop(case):
    """16-token prompts, 8 greedy tokens: ``generate`` against ``repro``'s
    prefill-and-decode loop (scout's chunk ring grown to its width)."""
    jcfg, jparams, tcfg, model = pair(case)
    B, P, n = 2, 16, 8
    prompt = tokens(tcfg, (B, P), 3)
    got, _, _ = generate(tcfg, model, torch.from_numpy(prompt), n)
    logits, cache = jax.jit(functools.partial(jT.prefill, jcfg))(
        jparams, jnp.asarray(prompt))
    cache = jT.grow_cache(jcfg, cache, B, max(P + n, jcfg.attn_chunk or 0))
    decode = jax.jit(functools.partial(jT.decode_step, jcfg))
    token = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    want = [np.asarray(token)]
    for i in range(n - 1):
        logits, cache = decode(jparams, token, cache, jnp.int32(P + i))
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(token))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))


# scout's chunk rings take one position for the batch, so its server runs
# the same MoE stack with full attention (repro's asserts so too)
SERVED = {"deepseek": {}, "scout": {"attn_chunk": 0}}


@pytest.mark.parametrize("case", list(SERVED))
def test_server_tokens_equal_repro(case):
    """3 requests over 2 slots (the third, shorter, takes the slot the
    second frees, whose row it zeroes past its prompt; deepseek's prefix
    rows are written too): token lists equal.  Two prompt lengths, so
    ``repro``'s server compiles two prefills."""
    jcfg, jparams, tcfg, model = pair(case, **SERVED[case])
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, tcfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((5, 6), (9, 4), (5, 7))]
    jsrv = JServer(jcfg, jparams, n_slots=2, max_seq=32)
    tsrv = BatchedServer(tcfg, model, n_slots=2, max_seq=32)
    jreqs = [jsrv.submit(p, m) for p, m in reqs]
    treqs = [tsrv.submit(p, m) for p, m in reqs]
    assert tsrv.run_until_drained(100) == jsrv.run_until_drained(100)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


@pytest.mark.parametrize("case", list(ARCHS))
def test_train_step(case):
    """One SGD step (the loss with the aux added) at S 48."""
    jcfg, jparams, tcfg, model = pair(case)
    toks = tokens(tcfg, (2, 49), 5)
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, lr=LR))(
        jparams, {"tokens": jnp.asarray(toks)})
    tnew, tm = tsteps.make_train_step(tcfg, lr=LR)(
        model, tT.param_dict(model), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **AUX_TOL)
    got = transformer_params_to_numpy(tnew)
    n = 0
    for path, leaf in _leaves(jnew):
        np.testing.assert_allclose(_node(got, path), np.asarray(leaf),
                                   err_msg=str(path), **STEP_TOL)
        n += 1
    assert n == len(list(_leaves(got)))
    router = "stack.0.sub0.mlp.router"
    assert not torch.equal(tnew[router], tT.param_dict(model)[router])


def test_weights_and_checkpoint_round_trip(tmp_path):
    """deepseek's tree (the ``prefix`` list, MoE and MLA leaves, the f32
    router) -> the port's model -> numpy is ``repro``'s tree bit for bit;
    a checkpoint either package writes loads in the other."""
    jcfg, jparams, tcfg, model = pair("deepseek")
    back = transformer_params_to_numpy(model)
    assert isinstance(back["prefix"], list) and len(back["prefix"]) == 1
    assert tck.tree_digest(back) == jck.tree_digest(jparams)
    tree = tck.load_checkpoint(jck.save_checkpoint(str(tmp_path / "j"), 1,
                                                   jparams), back)
    again = transformer_params_from_jax(tree, tcfg, "cpu")
    assert tck.tree_digest(transformer_params_to_numpy(again)) == \
        jck.tree_digest(jparams)
    doubled = {k: v * 2 for k, v in tT.param_dict(model).items()}
    tpath = tck.save_checkpoint(str(tmp_path / "t"), 1,
                                transformer_params_to_numpy(doubled))
    assert jck.tree_digest(jck.load_checkpoint(tpath, jparams)) == \
        jck.tree_digest(jax.tree_util.tree_map(lambda w: w * 2, jparams))
    bf16 = tT.Transformer(tcfg, torch.bfloat16, "meta")
    assert bf16.stack[0].sub0.mlp.router.dtype == torch.float32


@pytest.mark.parametrize("form", ["full", "reduced"])
@pytest.mark.parametrize("case", list(ARCHS))
def test_config_fields_equal_repro(case, form):
    j, t = jget_config(ARCHS[case]), tget_config(ARCHS[case])
    if form == "reduced":
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [dataclasses.astuple(s) for s in t.sublayers()] == \
        [dataclasses.astuple(s) for s in j.sublayers()]
    assert dataclasses.astuple(t.prefix_sublayer()) == \
        dataclasses.astuple(j.prefix_sublayer())


@pytest.mark.parametrize("case", list(ARCHS))
def test_param_count_equals_repro_at_full_size(case):
    jcfg, tcfg = jget_config(ARCHS[case]), tget_config(ARCHS[case])
    for active in (False, True):
        assert tT.param_count(tcfg, active_only=active) == \
            jT.param_count(jcfg, active_only=active)
    if case == "deepseek":
        assert tT.param_count(tcfg) == 15_706_484_224
        assert tT.param_count(tcfg, active_only=True) == 2_661_150_208
    else:
        assert tT.param_count(tcfg) == 107_769_861_120
