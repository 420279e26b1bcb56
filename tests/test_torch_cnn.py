"""The port's paper CNN and local training against ``repro``'s, from the
same init (JAX's, through ``params_from_jax``) and the same minibatches.

Tolerances: both sides compute in f32, but XLA:CPU and PyTorch's CPU
convolutions and matmuls sum in different orders (and XLA contracts some
multiply-adds into FMAs), so each op differs by a few ulps.  Logits and one
step agree to ~1e-6; a few SGD steps carry the differences forward, hence
the slightly wider bands on multi-step results."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.client as jclient
import repro.core.mafl as jmafl
import repro.models.cnn as jcnn
import repro_torch.core.client as tclient
import repro_torch.core.mafl as tmafl
import repro_torch.models.cnn as tcnn
from repro_torch.convert import params_from_jax, params_to_numpy
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def init():
    return {k: np.asarray(v)
            for k, v in jcnn.init_cnn(jax.random.PRNGKey(4)).items()}


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 28, 28, 1), dtype=np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _assert_params_close(jtree, tparams, tol):
    tnp = params_to_numpy(tparams)
    for k, v in jtree.items():
        np.testing.assert_allclose(tnp[k], np.asarray(v), err_msg=k, **tol)


def test_forward_and_loss(init):
    img, lab = _batch(16)
    jl = jcnn.cnn_forward(init, jnp.asarray(img))
    tl = tcnn.cnn_forward(params_from_jax(init, "cpu"), torch.from_numpy(img))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    jloss = jcnn.cross_entropy_loss(jl, jnp.asarray(lab))
    tloss = tcnn.cross_entropy_loss(tl, torch.from_numpy(lab))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(
        float(tcnn.accuracy(tl, torch.from_numpy(lab))),
        float(jcnn.accuracy(jl, jnp.asarray(lab))))


def test_one_sgd_step(init):
    img, lab = _batch(32, seed=1)
    jp, jloss = jcnn.sgd_train_step(init, jnp.asarray(img), jnp.asarray(lab),
                                    0.03)
    tp, tloss = tcnn.sgd_train_step(params_from_jax(init, "cpu"),
                                    torch.from_numpy(img),
                                    torch.from_numpy(lab), 0.03)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    _assert_params_close(jp, tp, STEP_TOL)


def test_vehicle_local_update_same_batches_and_scan(init):
    """Same shard and seed: identical minibatch draws, and the l-step scan
    lands on the same params, also truncated to its first 2 steps (partial
    computation: all 4 batches drawn, 2 applied)."""
    imgs, labs = _batch(60, seed=2)
    jveh = jclient.Vehicle(jclient.VehicleData(3, imgs, labs), lr=0.03,
                           batch_size=24, seed=5)
    tveh = tclient.Vehicle(tclient.VehicleData(3, imgs, labs), lr=0.03,
                           batch_size=24, seed=5, device="cpu")
    for a, b in zip(jveh.sample_batches(3), tveh.sample_batches(3)):
        np.testing.assert_array_equal(a, b)
    jp, jloss = jveh.local_update(init, 4)
    tp, tloss = tveh.local_update(params_from_jax(init, "cpu"), 4)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_params_close(jp, tp, SCAN_TOL)
    jp, jloss = jveh.local_update(init, 4, n_ep=2)
    tp, tloss = tveh.local_update(params_from_jax(init, "cpu"), 4, n_ep=2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_params_close(jp, tp, SCAN_TOL)


def test_local_update_many_chunk_path_matches_serial_path(init):
    """chunk=2 over 5 payloads: two vmapped chunks plus one serial
    remainder, against every event through the serial loop.  vmap batches
    the convolutions as grouped convolutions, which sum in another order."""
    rng = np.random.default_rng(3)
    base = params_from_jax(init, "cpu")
    payloads = [{k: v + 0.01 * i for k, v in base.items()} for i in range(5)]
    batches = [_batch(3 * 8, seed=10 + i) for i in range(5)]
    batches = [(im.reshape(3, 8, 28, 28, 1), lb.reshape(3, 8))
               for im, lb in batches]
    lr = float(rng.uniform(0.01, 0.05))
    outs, losses = tclient.local_update_many(payloads, batches, lr, chunk=2)
    ref_outs, ref_losses = tclient.local_update_many(payloads, batches, lr,
                                                     chunk=1)
    assert len(outs) == len(ref_outs) == 5
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for o, r in zip(outs, ref_outs):
        for k in o:
            np.testing.assert_allclose(o[k].numpy(), r[k].numpy(),
                                       err_msg=k, **STEP_TOL)
    # and the serial path is repro's
    jp, jloss = jclient._local_scan_jit(
        init, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]), lr)
    _assert_params_close(jp, ref_outs[0], SCAN_TOL)
    np.testing.assert_allclose(ref_losses[0], float(jloss), rtol=1e-5)


def test_params_from_jax_round_trip_and_checks(init):
    t = params_from_jax(init, "cpu")
    assert all(v.dtype == torch.float32 for v in t.values())
    back = params_to_numpy(t)
    for k, v in init.items():
        np.testing.assert_array_equal(back[k], v)
    assert back[k] is not v                    # a copy, not the caller's
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax({k: v for k, v in init.items() if k != "fc2_b"},
                        "cpu")
    with pytest.raises(ValueError, match="fc1_w"):
        params_from_jax(dict(init, fc1_w=init["fc1_w"].T), "cpu")
    with pytest.raises(ValueError, match="conv1_b"):
        params_from_jax(dict(init, conv1_b=init["conv1_b"].astype(
            np.float64)), "cpu")


def test_max_pool_ties_split_gradient_like_jax():
    """Tied maxima share the gradient evenly on both sides (F.max_pool2d
    would send all of it to one element)."""
    x = np.array([[1., 1., 0., 2.], [1., 0.5, 2., 2.],
                  [3., 3., 3., 3.], [-1., 0., 4., 4.]], np.float32)
    x = x.reshape(1, 4, 4, 1)                                  # NHWC
    up = np.arange(1., 5., dtype=np.float32).reshape(1, 2, 2, 1)

    def jloss(a):
        return jnp.sum(jcnn._max_pool_2x2(a) * up)
    jval = jcnn._max_pool_2x2(jnp.asarray(x))
    jgrad = jax.grad(jloss)(jnp.asarray(x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    tval = tcnn._max_pool_2x2(tx)
    (tval * torch.from_numpy(up).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_array_equal(tval.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jval))
    np.testing.assert_array_equal(tx.grad.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jgrad))
    assert tx.grad[0, 0, 0, 0] == pytest.approx(1 / 3)


def test_init_cnn_distributions():
    p = tcnn.init_cnn(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == tcnn.CNN_SHAPES
    for k, v in p.items():
        assert v.dtype == torch.float32
        if k.endswith("_b"):
            assert not v.any()
        else:
            fan_in = int(np.prod(v.shape[:-1]))
            assert float(v.std()) == pytest.approx(fan_in ** -0.5, rel=0.1)
    q = tcnn.init_cnn(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_evaluate_matches_repro_with_ragged_batch(init):
    img, lab = _batch(250, seed=7)
    jacc, jloss = jmafl.evaluate(init, img, lab, batch=100)
    tacc, tloss = tmafl.evaluate(params_from_jax(init, "cpu"), img, lab,
                                 batch=100, device="cpu")
    assert tacc == jacc
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
