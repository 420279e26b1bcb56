"""The SSM architectures through the port's entry points against
``repro``'s on the same weights (the port's seeded init, as numpy) and
tokens: reduced rwkv6-1.6b (two periods of [time-mix + channel-mix] under
LayerNorm) and reduced jamba-v0.1-52b (one period of [Mamba + dense, full
attention + MoE 4 experts top-2], n_kv 1): prefill logits and every cache
leaf at S 128 (the scans in two checkpointed chunks) and S 100 (one plain
scan), then teacher-forced decode steps; greedy ``generate`` tokens;
``BatchedServer`` tokens; one ``make_train_step`` at S 128; the weight and
checkpoint round trip with float32 leaves kept float32 in a bf16 model;
config fields; the full-size ``param_count``.

Tolerances are ``tests/_torch_archs.py``'s and ``test_torch_archs_moe.py``'s:
logits atol 1e-4 / rtol 1e-4, cache leaves atol 1e-5, losses rtol 1e-5,
parameters after one SGD step atol 1e-6 / rtol 1e-5; tokens and
checkpoints exact.  One leaf takes a looser bar: the time-mix state
``wkv`` sums 100-132 decayed products ``k v^T`` into values up to 56, where
the two packages differ by up to 3.15e-5 (6.6e-7 of the leaf's largest
value; every other leaf is under 5.1e-6, the logits under 1.6e-5), so each
leaf is held to atol max(1e-5, 1e-6 x its largest |value|)."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_archs import CACHE_TOL, LOGIT_TOL, tokens
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

LOSS_TOL = dict(atol=0, rtol=1e-5)
STATE_SCALE = 1e-6        # cache bar per unit of a leaf's largest |value|
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
LR = 0.05
ARCHS = {"rwkv": "rwkv6-1.6b", "jamba": "jamba-v0.1-52b"}
# float32 leaves of a bf16 model, as repro keeps them
F32_LEAVES = {"rwkv": ("mixer.w0", "mixer.u"),
              "jamba": ("mixer.A_log", "mixer.D", "mlp.router")}


@functools.lru_cache(maxsize=None)
def pair(case):
    """(repro cfg, repro params, port cfg, port model on the CPU): the
    port's init from a seed, the LayerNorm biases, ``w0`` and Mamba's
    ``conv_b``/``dt_bias`` (constants at init) redrawn so that they count,
    handed to ``repro`` as numpy."""
    jcfg = jget_config(ARCHS[case]).reduced()
    tcfg = tget_config(ARCHS[case]).reduced()
    model = tT.init_params(tcfg, torch.Generator().manual_seed(1),
                           device="cpu")
    rng = np.random.default_rng(4)
    redraw = {"bias": (0.1, 0.0), "w0": (1.0, -3.0), "conv_b": (0.1, 0.0),
              "dt_bias": (0.5, -4.0)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[1]
        if leaf in redraw:
            s, o = redraw[leaf]
            p.copy_(torch.from_numpy(
                (o + s * rng.standard_normal(p.shape)).astype(np.float32)))
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


def assert_cache(tcache, jcache, where):
    """Every leaf of both caches (``mixer`` and ``mlp`` groups): the same
    paths and shapes, values within ``CACHE_TOL``."""
    got, want = dict(_leaves(tcache)), dict(_leaves(jcache))
    assert set(got) == set(want), where
    for path, w in want.items():
        w = np.asarray(w)
        assert tuple(got[path].shape) == w.shape, (where, path)
        atol = max(CACHE_TOL["atol"], STATE_SCALE * float(np.abs(w).max()))
        np.testing.assert_allclose(got[path].numpy(), w, atol=atol, rtol=0,
                                   err_msg=f"{where} {path}")


@pytest.mark.parametrize("S", [128, 100])
@pytest.mark.parametrize("case", list(ARCHS))
def test_prefill_and_decode_match_repro(case, S):
    """Prefill logits and every cache leaf, then 4 teacher-forced decode
    steps (logits and every leaf after each)."""
    jcfg, jparams, tcfg, model = pair(case)
    B, steps = 2, 4
    toks = tokens(tcfg, (B, S + steps), 6)
    jl, jc = jax.jit(functools.partial(jT.prefill, jcfg))(
        jparams, jnp.asarray(toks[:, :S]))
    tl, tc = tT.prefill(tcfg, model, torch.from_numpy(toks[:, :S]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_cache(tc, jc, f"prefill S {S}")
    jc = jT.grow_cache(jcfg, jc, B, S + steps)
    tc = tT.grow_cache(tcfg, tc, B, S + steps)
    decode = jax.jit(functools.partial(jT.decode_step, jcfg))
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = decode(jparams, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = tT.decode_step(tcfg, model, torch.from_numpy(tok), tc,
                                S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **LOGIT_TOL)
        assert_cache(tc, jc, f"S {S} step {i}")


@pytest.mark.parametrize("case", list(ARCHS))
def test_generate_tokens_equal_repro_greedy_loop(case):
    """16-token prompts, 8 greedy tokens: ``generate`` against ``repro``'s
    prefill-and-decode loop."""
    jcfg, jparams, tcfg, model = pair(case)
    B, P, n = 2, 16, 8
    prompt = tokens(tcfg, (B, P), 3)
    got, _, _ = generate(tcfg, model, torch.from_numpy(prompt), n)
    logits, cache = jax.jit(functools.partial(jT.prefill, jcfg))(
        jparams, jnp.asarray(prompt))
    cache = jT.grow_cache(jcfg, cache, B, P + n)
    decode = jax.jit(functools.partial(jT.decode_step, jcfg))
    token = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    want = [np.asarray(token)]
    for i in range(n - 1):
        logits, cache = decode(jparams, token, cache, jnp.int32(P + i))
        token = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(token))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))


@pytest.mark.parametrize("case", list(ARCHS))
def test_server_tokens_equal_repro(case):
    """3 requests over 2 slots (the third, shorter, takes the slot the
    second frees: its state row is overwritten whole, its K/V row zeroed
    past its prompt): token lists equal."""
    jcfg, jparams, tcfg, model = pair(case)
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
    """One SGD step at S 128 (the scans in two checkpointed chunks, inside
    the period's checkpoint)."""
    jcfg, jparams, tcfg, model = pair(case)
    toks = tokens(tcfg, (2, 129), 5)
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, lr=LR))(
        jparams, {"tokens": jnp.asarray(toks)})
    tnew, tm = tsteps.make_train_step(tcfg, lr=LR)(
        model, tT.param_dict(model), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    got = transformer_params_to_numpy(tnew)
    n = 0
    for path, leaf in _leaves(jnew):
        np.testing.assert_allclose(_node(got, path), np.asarray(leaf),
                                   err_msg=str(path), **STEP_TOL)
        n += 1
    assert n == len(list(_leaves(got)))
    for name in F32_LEAVES[case]:
        if name == "mlp.router":
            name = "stack.0.sub1." + name
        else:
            name = "stack.0.sub0." + name
        assert not torch.equal(tnew[name], tT.param_dict(model)[name]), name


@pytest.mark.parametrize("case", list(ARCHS))
def test_weights_and_checkpoint_round_trip(case, tmp_path):
    """The port's model -> numpy is ``repro``'s tree bit for bit and back
    (LayerNorm's ``bias``, Mamba's and RWKV's leaves); a checkpoint either
    package writes loads in the other; in a bf16 model the float32 leaves
    stay float32."""
    jcfg, jparams, tcfg, model = pair(case)
    back = transformer_params_to_numpy(model)
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
    dtypes = {n: p.dtype for n, p in bf16.named_parameters()}
    f32 = {n for n, dt in dtypes.items() if dt == torch.float32}
    assert f32 == {n for n in dtypes
                   if n.split(".", 3)[-1] in F32_LEAVES[case]}
    if case == "rwkv":
        assert {"final_norm.bias", "stack.0.sub0.ln1.bias"} <= set(dtypes)


@pytest.mark.parametrize("form", ["full", "reduced"])
@pytest.mark.parametrize("case", list(ARCHS))
def test_config_fields_equal_repro(case, form):
    j, t = jget_config(ARCHS[case]), tget_config(ARCHS[case])
    if form == "reduced":
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [dataclasses.astuple(s) for s in t.sublayers()] == \
        [dataclasses.astuple(s) for s in j.sublayers()]
    assert t.supports_long_context == j.supports_long_context
    assert t.is_attention_free == j.is_attention_free


@pytest.mark.parametrize("case", list(ARCHS))
def test_param_count_equals_repro_at_full_size(case):
    jcfg, tcfg = jget_config(ARCHS[case]), tget_config(ARCHS[case])
    for active in (False, True):
        assert tT.param_count(tcfg, active_only=active) == \
            jT.param_count(jcfg, active_only=active)
    if case == "rwkv":
        assert tT.param_count(tcfg) == 1_584_041_984
    else:
        assert tT.param_count(tcfg) == 51_570_315_264
