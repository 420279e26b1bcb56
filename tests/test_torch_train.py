"""Transformer training in the port against ``repro`` on smollm-360m
reduced (G = 4) and its G = 3 variant, with ``repro``'s ``T.init_params``
weights and the same numpy tokens: the training forward, the loss and its
gradient, ``make_train_step`` (M = 1 and 2, the vocab-chunked loss, the
q-blocked attention at S = 1152), ``make_mafl_step`` and
``make_lm_local_step``.

Tolerances (both sides f32 on the CPU, summing matrix products in
different orders): logits atol/rtol 1e-4, as ``test_torch_transformer.py``;
losses rtol 1e-5; gradients atol 1e-5 / rtol 1e-4 (entries up to ~0.05,
a few ulps per layer); parameters after one SGD step atol 1e-6 / rtol 1e-5
(lr times the gradient band, on weights of size ~0.01-1)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_world import transformer_pair
from repro.core.client import make_lm_local_step as jmake_lm_local_step
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as jT
from repro_torch.convert import transformer_params_to_numpy
from repro_torch.core.client import make_lm_local_step
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tT
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=0, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
VARIANTS = {"reduced": None, "G3": dict(n_heads=6, n_kv_heads=2)}
LR = 0.05


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return transformer_pair(VARIANTS[request.param])


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _assert_tree(tparams, jtree, tol, what):
    """A port param dict against a ``repro`` pytree, leaf by leaf."""
    got = transformer_params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_j:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf),
                                   err_msg=f"{what} {path}", **tol)


def test_forward_logits(pair):
    jcfg, jparams, tcfg, model = pair
    tokens = _tokens(tcfg, (2, 16), 0)
    jlogits, jaux = jT.forward(jcfg, jparams, jnp.asarray(tokens))
    tlogits, taux = tT.forward(tcfg, model, torch.from_numpy(tokens))
    assert tlogits.shape == (2, 16, tcfg.vocab_size)
    assert taux.shape == () and taux.dtype == torch.float32
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    jh, _ = jT.forward_hidden(jcfg, jparams, jnp.asarray(tokens))
    th, _ = tT.forward_hidden(tcfg, model, torch.from_numpy(tokens))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_array_equal(
        tT.head_weight(tcfg, tT.param_dict(model)).numpy(),
        np.asarray(jT.head_weight(jcfg, jparams)))


@pytest.mark.parametrize("variant", [dict(sliding_window=5),
                                     dict(attn_chunk=4)],
                         ids=["swa", "chunk"])
def test_forward_logits_under_local_masks(variant):
    """Training attention takes ``repro``'s sliding-window and chunked
    masks (serving rejects them: their ring caches are not ported)."""
    jcfg, jparams, tcfg, model = transformer_pair(variant)
    tokens = _tokens(tcfg, (2, 13), 6)
    jlogits, _ = jT.forward(jcfg, jparams, jnp.asarray(tokens))
    tlogits, _ = tT.forward(tcfg, model, torch.from_numpy(tokens))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)


def test_value_and_grad(pair):
    """``train.py``'s loss (through K3's plain version here) and its
    gradient against ``repro``'s ``lm_loss_and_grad``."""
    jcfg, jparams, tcfg, model = pair
    tokens = _tokens(tcfg, (3, 17), 1)
    jloss, jgrads = jtrain.lm_loss_and_grad(jcfg)(jparams,
                                                  jnp.asarray(tokens))
    tloss, tgrads = ttrain.lm_loss_and_grad(tcfg, model)(
        tT.param_dict(model), torch.from_numpy(tokens))
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_tree(tgrads, jgrads, GRAD_TOL, "grad")


# make_train_step cases: (config variant, tokens shape [B, S + 1])
TRAIN_CASES = {
    "M1": (dict(), (4, 33)),
    "M2": (dict(microbatches=2), (4, 33)),
    "chunked": (dict(loss_chunk=200), (2, 33)),     # 3 chunks, 88 padded
    "qblocked": (dict(), (1, 1153)),                # S = 1152 > 1024
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step(case):
    variant, shape = TRAIN_CASES[case]
    jcfg, jparams, tcfg, model = transformer_pair(variant)
    tokens = _tokens(tcfg, shape, 2)
    jnew, jmetrics = jax.jit(jsteps.make_train_step(jcfg, lr=LR))(
        jparams, {"tokens": jnp.asarray(tokens)})
    tnew, tmetrics = tsteps.make_train_step(tcfg, lr=LR)(
        model, tT.param_dict(model), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(jmetrics["loss"]), **LOSS_TOL)
    _assert_tree(tnew, jnew, STEP_TOL, case)


def test_train_step_unported_inputs_raise():
    _, _, tcfg, model = transformer_pair()
    # grad_specs is ported (item 13, part 2): the step builds, as repro's
    # does; sharded steps are held in test_torch_shard_steps.py
    assert callable(tsteps.make_train_step(tcfg, grad_specs={}))
    # a vision config without its patch embeddings raises, as repro asserts
    vision = tcfg.variant(frontend="vision", n_frontend_tokens=2)
    batch = {"tokens": torch.zeros(1, 5, dtype=torch.int32)}
    with pytest.raises(ValueError, match="frontend_embeds"):
        tsteps.make_train_step(vision)(model, tT.param_dict(model), batch)
    # the checkpoint policies are ported (item 12, part 2): they run and
    # give the logits of the default policy bitwise
    want, _ = tT.forward(tcfg, model, batch["tokens"])
    for policy in (dict(remat_policy="dots"), dict(remat_policy="dots_nb"),
                   dict(remat_sublayer=True)):
        got, _ = tT.forward(tcfg.variant(**policy), model, batch["tokens"])
        assert torch.equal(got, want)
    # shard_activations without a mesh raises, as repro's
    # with_sharding_constraint does outside one
    with pytest.raises(RuntimeError, match="needs a mesh"):
        tT.forward(tcfg.variant(shard_activations=True), model,
                   batch["tokens"])


def test_no_remat_matches_checkpointed_periods():
    """``no_remat`` (plain autograd through the periods) and the default
    checkpointed periods give the same loss and gradients; with
    ``no_remat`` a ``dots`` policy is never consulted, as in ``repro``."""
    _, _, tcfg, model = transformer_pair()
    tokens = torch.from_numpy(_tokens(tcfg, (2, 9), 3))
    out = []
    for cfg in (tcfg, tcfg.variant(no_remat=True, remat_policy="dots")):
        out.append(ttrain.lm_loss_and_grad(cfg, model)(tT.param_dict(model),
                                                       tokens))
    assert float(out[0][0]) == float(out[1][0])
    for k, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], g, rtol=0, atol=0)


def test_make_mafl_step(pair):
    jcfg, jparams, tcfg, model = pair
    rng = np.random.default_rng(4)
    jlocal = jax.tree_util.tree_map(
        lambda w: w + rng.normal(size=w.shape).astype(np.float32) * 0.01,
        jparams)
    local_np = jax.tree_util.tree_map(np.asarray, jlocal)
    from repro_torch.convert import transformer_params_from_jax
    tlocal = tT.param_dict(transformer_params_from_jax(local_np, tcfg, "cpu"))
    beta, weight = 0.5, 0.8719
    jout = jsteps.make_mafl_step(jcfg)(jparams, jlocal, jnp.float32(beta),
                                       jnp.float32(weight))
    tout = tsteps.make_mafl_step(tcfg)(tT.param_dict(model), tlocal, beta,
                                       weight)
    _assert_tree(tout, jout, dict(atol=1e-7, rtol=1e-6), "mafl")


def test_make_lm_local_step(pair):
    jcfg, jparams, tcfg, model = pair
    tokens = _tokens(tcfg, (2, 13), 5)
    jnew, jloss = jmake_lm_local_step(jcfg, jT.forward)(
        jparams, jnp.asarray(tokens), LR)
    step = make_lm_local_step(
        tcfg, lambda cfg, p, t: tT.apply_params(cfg, model, p, t))
    tnew, tloss = step(tT.param_dict(model), torch.from_numpy(tokens), LR)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_tree(tnew, jnew, STEP_TOL, "local step")
