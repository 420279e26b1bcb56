"""K3 on the CPU: the port's ``cross_entropy`` / ``lm_loss`` (the plain
version a CPU tensor takes) against ``repro``'s ``ops.cross_entropy``
(its Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it)
and ``ref.cross_entropy``, on the same numpy logits.

Tolerances: nll atol 1e-4 (the bar of ``repro``'s own kernel test); rows of
+-1e4 logits atol 1e-3 (``repro``'s bar for them: lse ~ 1e4, where one f32
ulp is 1e-3); the gradient of the mean loss atol 1e-6 (entries are at most
1 / rows; the two sides round exp and log differently by a few ulps)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cross_entropy import ops as jops
from repro.kernels.cross_entropy import ref as jref
from repro_torch import kernels
from repro_torch.kernels.cross_entropy import ops as tops
from repro_torch.kernels.cross_entropy import ref as tref
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NLL_TOL = dict(atol=1e-4, rtol=0)
EXTREME_TOL = dict(atol=1e-3, rtol=0)
GRAD_TOL = dict(atol=1e-6, rtol=0)
SHAPES = [(128, 2048), (64, 4096), (100, 3000), (8, 512), (256, 1111)]


def _inputs(R, V, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, V)) * 3).astype(np.float32)
    y = rng.integers(0, V, R).astype(np.int32)
    y[0], y[-1] = 0, V - 1
    return x, y


@pytest.mark.parametrize("R,V", SHAPES)
def test_cross_entropy_matches_repro(R, V):
    x, y = _inputs(R, V, R * V)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    kernels.reset_launches()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = tops.cross_entropy(tx, ty)
    assert got.dtype == torch.float32 and got.shape == (R,)
    assert kernels.launch_counts()["cross_entropy"] == 0     # CPU: plain
    np.testing.assert_allclose(got.numpy(), jops.cross_entropy(jx, jy),
                               **NLL_TOL)
    np.testing.assert_allclose(got.numpy(), jref.cross_entropy(jx, jy),
                               **NLL_TOL)
    np.testing.assert_allclose(tref.cross_entropy(tx, ty).numpy(),
                               jref.cross_entropy(jx, jy), **NLL_TOL)
    nll, lse = tops.nll_and_lse(tx, ty.long())
    np.testing.assert_allclose(nll.numpy(), got.numpy(), **NLL_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               jax.nn.logsumexp(jx, axis=-1), **NLL_TOL)


def test_cross_entropy_extreme_logits_stable():
    """``repro``'s extreme-logit case, and the same rows with other
    labels."""
    x = np.array([[1e4, -1e4, 0.0, 5.0] * 128] * 8, np.float32)
    for labels in (np.zeros(8, np.int32), np.arange(8, dtype=np.int32)):
        got = tops.cross_entropy(torch.from_numpy(x),
                                 torch.from_numpy(labels)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(
            got, jops.cross_entropy(jnp.asarray(x), jnp.asarray(labels)),
            **EXTREME_TOL)
        np.testing.assert_allclose(
            got, jref.cross_entropy(jnp.asarray(x), jnp.asarray(labels)),
            **EXTREME_TOL)


def test_cross_entropy_bf16_logits():
    """bf16 logits read as f32 on both sides (the same bf16 values)."""
    x, y = _inputs(64, 1111, 7)
    tx = torch.from_numpy(x).bfloat16()
    jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    got = tops.cross_entropy(tx, torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               jops.cross_entropy(jx, jnp.asarray(y)),
                               **NLL_TOL)
    np.testing.assert_allclose(got.numpy(),
                               jref.cross_entropy(jx, jnp.asarray(y)),
                               **NLL_TOL)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "plain"])
def test_lm_loss_and_gradient_match_repro(use_kernel):
    """The mean loss over [B, S, V] logits and its gradient against
    ``jax.grad`` of ``repro``'s ``log_softmax`` loss (its training
    loop's), through ``torch.autograd`` and ``torch.func``."""
    B, S, V = 2, 9, 512
    x, y = _inputs(B * S, V, 11)
    x, y = x.reshape(B, S, V), y.reshape(B, S)

    def jloss(logits):
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return jnp.mean(-jnp.take_along_axis(logp, jnp.asarray(y)[..., None],
                                             -1))
    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(x))
    np.testing.assert_allclose(
        float(jops.lm_loss(jnp.asarray(x), jnp.asarray(y))), float(jval),
        **NLL_TOL)

    tx, ty = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y)
    loss = tops.lm_loss(tx, ty, use_kernel=use_kernel)
    (g_autograd,) = torch.autograd.grad(loss, tx)
    g_func, val = torch.func.grad_and_value(
        lambda t: tops.lm_loss(t, ty, use_kernel=use_kernel))(tx.detach())
    np.testing.assert_allclose(float(loss.detach()), float(jval), **NLL_TOL)
    np.testing.assert_allclose(float(val), float(jval), **NLL_TOL)
    for g in (g_autograd, g_func):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_backward_keeps_the_logits_dtype():
    x, y = _inputs(16, 512, 3)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    (g,) = torch.autograd.grad(tops.cross_entropy(tx, torch.from_numpy(y))
                               .sum(), tx)
    assert g.dtype == torch.bfloat16
    want = tops.grad_logits(tx.detach().float(), torch.from_numpy(y),
                            tops.nll_and_lse(tx.detach(),
                                             torch.from_numpy(y))[1],
                            torch.ones(16))
    torch.testing.assert_close(g, want.bfloat16())


@pytest.mark.parametrize("bad", ["dtype", "labels", "shape", "rows", "V0",
                                 "device"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros(4, 8)
    y = torch.zeros(4, dtype=torch.int32)
    args = {"dtype": (x.half(), y), "labels": (x, y.float()),
            "shape": (x[0], y), "rows": (x, y[:3]), "V0": (x[:, :0], y),
            "device": (torch.zeros(4, 8, device="meta"),
                       torch.zeros(4, dtype=torch.int32, device="meta"))}[bad]
    with pytest.raises((ValueError, TypeError)):
        tops.nll_and_lse(*args)
