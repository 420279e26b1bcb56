"""The port's fleet engine (``engine="jit"``) under fault injection against
``repro``'s, on the CPU, from one (JAX-drawn) init with the kernel path on
(``_torch_engines.py``): fleet-k100 with ``flaky`` cut to 20 rounds and 2
local steps (the same ``extras["faults"]`` and trace, times in the f32
band of ``_torch_world.py``, params within ``PARAM_TOL``), the partial
local scan its waves train with against ``repro``'s on the same numpy
inputs, and faults off bitwise the run without faults."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.client as jclient
import repro_torch.core.client as tclient
from _torch_engines import (assert_faults_off,  # noqa: F401
                            faults_fleet_pair, init)
from _torch_world import assert_fleet_conforms
from repro_torch.models.cnn import CNN_SHAPES


def _scan_inputs(n, l_iters=3, b=8, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.normal(size=(n,) + s) * 0.1).astype(np.float32)
              for k, s in CNN_SHAPES.items()}
    imgs = rng.normal(size=(n, l_iters, b, 28, 28, 1)).astype(np.float32)
    labs = rng.integers(0, 10, size=(n, l_iters, b)).astype(np.int32)
    return params, imgs, labs


def _close(tree, ref, **tol):
    for k, v in ref.items():
        np.testing.assert_allclose(tree[k].numpy(), np.asarray(v),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("n_ep", [1, 2, 3])
def test_local_scan_partial_matches_repro(n_ep):
    """Deadline semantics on ``repro``'s inputs, l_iters 3: the single
    scan against ``_local_scan_partial_jit``, the per-row and the shared
    vmaps against ``_local_scan_partial_vmap``; at ``n_ep == l_iters`` the
    port's partial scan is bitwise its own ``_local_scan``."""
    params, imgs, labs = _scan_inputs(3)
    lr = 0.05
    one = {k: v[0] for k, v in params.items()}
    jp, jl = jclient._local_scan_partial_jit(
        {k: jnp.asarray(v) for k, v in one.items()}, jnp.asarray(imgs[0]),
        jnp.asarray(labs[0]), lr, jnp.int32(n_ep))
    tone = {k: torch.from_numpy(v) for k, v in one.items()}
    timg, tlab = torch.from_numpy(imgs), torch.from_numpy(labs).long()
    tp, tl = tclient._local_scan_partial(tone, timg[0], tlab[0], lr,
                                         torch.tensor(n_ep))
    _close(tp, jp, rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    if n_ep == 3:
        fp, fl = tclient._local_scan(tone, timg[0], tlab[0], lr)
        assert all(torch.equal(fp[k], tp[k]) for k in fp)
        assert torch.equal(fl, tl)

    eps = np.array([n_ep, 1, 3], np.int32)
    jv, jls = jclient._local_scan_partial_vmap(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(imgs),
        jnp.asarray(labs), lr, jnp.asarray(eps))
    tv, tls = tclient._local_scan_partial_vmap(
        {k: torch.from_numpy(v) for k, v in params.items()}, timg, tlab, lr,
        torch.from_numpy(eps))
    _close(tv, jv, rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-5)
    # one payload broadcast to the wave: the shared form of the same scan
    shared = {k: np.broadcast_to(v[:1], v.shape) for k, v in params.items()}
    jv, _ = jclient._local_scan_partial_vmap(
        {k: jnp.asarray(v) for k, v in shared.items()}, jnp.asarray(imgs),
        jnp.asarray(labs), lr, jnp.asarray(eps))
    ts, _ = tclient._local_scan_partial_shared(tone, timg, tlab, lr,
                                               torch.from_numpy(eps))
    _close(ts, jv, rtol=1e-4, atol=2e-6)


@pytest.mark.parametrize("engine", ["jit"])
def test_fleet_k100_flaky_conforms(init, engine):
    """``repro``'s own replay-conformance world (fleet-k100, flaky, 20
    rounds, 2 local steps): drops, a blackout, two recovery sweeps and
    cap discards, on the fleet engine."""
    jres, tres = faults_fleet_pair("fleet-k100", engine, init, 10, rounds=20,
                                   l_iters=2, faults="flaky")
    summary = tres.extras["faults"]
    assert summary == jres.extras["faults"]
    assert summary["readmits"] and summary["counts"]["discarded_uploads"]
    assert_fleet_conforms(jres, tres)


@pytest.mark.parametrize("name, engine", [("quick-k5", "jit")])
def test_faults_off_is_bitwise_the_run_without_faults(name, engine):
    """Every off spelling runs the path without faults: the same trace,
    bitwise the same params, no fault summary."""
    assert_faults_off(name, engine)
