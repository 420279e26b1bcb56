"""The port's SSM layers against ``repro``'s on the same numpy weights and
inputs: ``layernorm``; ``chunked_scan`` forward and gradient (against
``jax.grad`` through ``repro``'s) at lengths that chunk (128, 192) and that
take the plain scan (100, and 64 = the chunk); ``mamba_fwd`` /
``mamba_decode`` (reduced jamba-v0.1-52b), ``time_mix_fwd`` /
``time_mix_decode`` and ``channel_mix_fwd`` / ``channel_mix_decode``
(reduced rwkv6-1.6b) with their caches; the port's prefill against its own
step-by-step decode; the decay strictly inside (0, 1).

Weights are the port's seeded init, with the leaves ``repro`` initialises
to constants (``w0``, ``conv_b``, ``dt_bias``, the norms' ``scale`` and
``bias``) redrawn from numpy so that they count.  Both sides f32 on the
CPU: module outputs and states atol 1e-5 / rtol 1e-5 (activations ~0.1-1,
states summed over up to 192 steps), the scan's gradients atol 1e-5 /
rtol 1e-5; prefill against decode atol 1e-4 (``repro``'s bar,
``tests/test_models.py``)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import mamba as jmamba
from repro.models import modules as jmodules
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config as tget_config
from repro_torch.models import mamba as tmamba
from repro_torch.models import modules as tmodules
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as tT

pytestmark = pytest.mark.usefixtures("one_thread")

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=0)
ARCHS = {"jamba": "jamba-v0.1-52b", "rwkv": "rwkv6-1.6b"}
# leaves repro initialises to constants, redrawn here: (scale, offset)
REDRAWN = {"w0": (1.0, -3.0), "conv_b": (0.1, 0.0), "dt_bias": (0.5, -4.0),
           "ln_scale": (0.1, 1.0)}


def cfgs(case):
    return (jget_config(ARCHS[case]).reduced(),
            tget_config(ARCHS[case]).reduced())


def module_pair(case, cls, seed):
    """(repro cfg, repro params, port cfg, port module on the CPU): the
    port's init, the constant leaves redrawn, handed to ``repro`` as
    numpy."""
    jcfg, tcfg = cfgs(case)
    m = cls(tcfg, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for name, p in m.named_parameters():
        if name in REDRAWN:
            s, o = REDRAWN[name]
            p.copy_(torch.from_numpy(
                (o + s * rng.standard_normal(p.shape)).astype(np.float32)))
    tree = {k: jnp.asarray(v.numpy()) for k, v in m.named_parameters()}
    return jcfg, tree, tcfg, m


def inputs(cfg, B, S, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def assert_tree(got: dict, want: dict, where, tol=OUT_TOL):
    assert set(got) == set(want), where
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), (where, k)
        assert got[k].dtype == torch.float32, (where, k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=f"{where} {k}", **tol)


@pytest.mark.parametrize("shape", [(3, 7, 256), (2, 5, 48)])
def test_layernorm_matches_repro(shape):
    """Population variance (``jnp.var``), shifted inputs so that a biased
    and an unbiased variance differ."""
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal(shape)).astype(np.float32)
    d = shape[-1]
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    want = jmodules.layernorm({"scale": scale, "bias": bias}, x, 1e-5)
    ln = tmodules.LayerNorm(d, 1e-5)
    ln.scale.copy_(torch.from_numpy(scale))
    ln.bias.copy_(torch.from_numpy(bias))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(),
                               np.asarray(want), **OUT_TOL)


def _jbody(a, c, x):
    c = jnp.tanh(a * c + x[0]) + 0.5 * x[1]
    return c, c * 2.0


@pytest.mark.parametrize("length,chunked", [(128, True), (192, True),
                                            (100, False), (64, False)])
def test_chunked_scan_value_and_grad_match_repro(length, chunked):
    """A tanh recurrence with a bound parameter ``a`` and two inputs a
    step: the carry, the outputs and the gradients of a weighted sum with
    respect to ``a``, the initial carry and both inputs equal ``repro``'s
    (``jax.grad``).  A chunking length runs every step twice (the forward
    and the chunk's recomputation in the backward); a plain one once."""
    rng = np.random.default_rng(length)
    n = 6
    a = rng.standard_normal(n).astype(np.float32) * 0.5
    c0 = rng.standard_normal((2, n)).astype(np.float32)
    xs = tuple(rng.standard_normal((length, 2, n)).astype(np.float32)
               for _ in range(2))
    wy = rng.standard_normal((length, 2, n)).astype(np.float32)
    wc = rng.standard_normal((2, n)).astype(np.float32)

    def jloss(a, c0, xs):
        c, ys = jmodules.chunked_scan(functools.partial(_jbody, a), c0, xs,
                                      64)
        return jnp.sum(ys * wy) + jnp.sum(c * wc), (c, ys)
    (jl, (jc, jys)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(a, c0, xs)

    calls = []

    def tbody(a, c, x):
        calls.append(1)
        c = torch.tanh(a * c + x[0]) + 0.5 * x[1]
        return c, c * 2.0
    ta, tc0 = (torch.from_numpy(v).requires_grad_() for v in (a, c0))
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    c, ys = tmodules.chunked_scan(functools.partial(tbody, ta), tc0, txs, 64)
    loss = (ys * torch.from_numpy(wy)).sum() + (c * torch.from_numpy(wc)).sum()
    assert len(calls) == length
    grads = torch.autograd.grad(loss, [ta, tc0, *txs])
    assert len(calls) == (2 if chunked else 1) * length
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), **OUT_TOL)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys),
                               **OUT_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = [jg[0], jg[1], *jg[2]]
    for name, g, w in zip(("a", "c0", "x0", "x1"), grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


@functools.lru_cache(maxsize=None)
def _jit(fn, case):
    return jax.jit(functools.partial(fn, cfgs(case)[0]))


def _decode_steps(jfn, tfn, jcache, tcache, jp, tp, cfg, seed, where):
    """Three decode steps from the prefill's cache on both sides: each
    step's output and state held."""
    for i in range(3):
        x = inputs(cfg, 2, 1, seed + i)
        jy, jcache = jfn(jp, x, jcache)
        ty, tcache = tfn(cfg, tp, torch.from_numpy(x), tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   err_msg=f"{where} step {i}", **OUT_TOL)
        assert_tree(tcache, jcache, f"{where} step {i}")


@pytest.mark.parametrize("S", [128, 100, 2])
def test_mamba_fwd_and_decode_match_repro(S):
    """S 128 chunks, S 100 does not; S 2 is shorter than ``d_conv - 1``,
    so the conv tail holds zeros before the prompt."""
    jcfg, jp, tcfg, tp = module_pair("jamba", tmamba.Mamba, 1)
    x = inputs(tcfg, 2, S, 2)
    jy, jc = _jit(jmamba.mamba_fwd, "jamba")(jp, x)
    ty, tc = tmamba.mamba_fwd(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    assert_tree(tc, jc, f"mamba_fwd S {S}")
    if S < tcfg.mamba_d_conv - 1:
        assert not tc["conv"][:, :tcfg.mamba_d_conv - 1 - S].any()
    _decode_steps(_jit(jmamba.mamba_decode, "jamba"), tmamba.mamba_decode,
                  jc, tc, jp, tp, tcfg, 3, f"mamba_decode after S {S}")


@pytest.mark.parametrize("S", [128, 100])
def test_time_mix_fwd_and_decode_match_repro(S):
    jcfg, jp, tcfg, tp = module_pair("rwkv", trwkv.TimeMix, 1)
    x = inputs(tcfg, 2, S, 2)
    jy, jc = _jit(jrwkv.time_mix_fwd, "rwkv")(jp, x)
    ty, tc = trwkv.time_mix_fwd(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    assert_tree(tc, jc, f"time_mix_fwd S {S}")
    _decode_steps(_jit(jrwkv.time_mix_decode, "rwkv"),
                  trwkv.time_mix_decode, jc, tc, jp, tp, tcfg, 3,
                  f"time_mix_decode after S {S}")


def test_channel_mix_fwd_and_decode_match_repro():
    jcfg, jp, tcfg, tp = module_pair("rwkv", trwkv.ChannelMix, 1)
    x = inputs(tcfg, 2, 9, 2)
    jy, jc = _jit(jrwkv.channel_mix_fwd, "rwkv")(jp, x)
    ty, tc = trwkv.channel_mix_fwd(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    assert_tree(tc, jc, "channel_mix_fwd")
    _decode_steps(_jit(jrwkv.channel_mix_decode, "rwkv"),
                  trwkv.channel_mix_decode, jc, tc, jp, tp, tcfg, 3,
                  "channel_mix_decode")


@pytest.mark.parametrize("case", list(ARCHS))
def test_prefill_matches_step_by_step_decode(case):
    """The port alone: prefill logits and state leaves of 9 tokens against
    9 decode steps from an empty cache (jamba's capacity factor 16, so the
    prefill's MoE drops nothing, as ``repro``'s test sets it)."""
    cfg = tget_config(ARCHS[case]).reduced().variant(capacity_factor=16.0)
    model = tT.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 9)))
    logits, pcache = tT.prefill(cfg, model, toks)
    cache = tT.init_cache(cfg, 2, 9, device="cpu")
    steps = [tT.decode_step(cfg, model, toks[:, i:i + 1], cache, i)[0]
             for i in range(9)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), logits.numpy(),
                               **STEP_TOL)
    for j, sub in enumerate(cfg.sublayers()):
        for group, leaves in pcache["stack"][f"sub{j}"].items():
            for k, v in leaves.items():
                got = cache["stack"][f"sub{j}"][group][k]
                if not tT.is_state(sub, group):
                    got = got[:, :, :v.shape[2]]
                np.testing.assert_allclose(got.numpy(), v.numpy(),
                                           err_msg=f"sub{j} {group} {k}",
                                           **STEP_TOL)


def test_decay_strictly_inside_unit_interval():
    """``w = exp(-exp(w0 + tanh(x A) B))`` over the port's init and inputs
    of unit scale, as ``repro``'s test draws them."""
    _, _, tcfg, tp = module_pair("rwkv", trwkv.TimeMix, 3)
    x = torch.from_numpy(inputs(tcfg, 1, 4, 1, scale=1.0))
    *_, w, _ = trwkv._tm_projections(tcfg, tp, x, torch.zeros_like(x))
    assert w.dtype == torch.float32
    assert bool((w > 0).all()) and bool((w < 1).all())
    assert float(w.max() - w.min()) > 0.1      # data-dependent, spread
