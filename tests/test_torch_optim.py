"""``repro_torch.optim`` and ``repro_torch.data.TokenPipeline`` against
``repro.optim`` and ``repro.data.pipeline`` on the same numpy inputs:
each optimizer over 5 steps of seeded gradients (weight decay, a
scheduled learning rate across its warmup boundary, gradients clipped by
their global norm), each schedule over steps 0-12, and the pipeline's
batches bit for bit for seeds 0-2.

Both sides f32 on the CPU: parameters and states rtol 1e-6 / atol 1e-7
(a few ulps of weights of size ~1), schedules rtol 1e-6."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro_torch.optim as topt
from _torch_threads import one_thread  # noqa: F401
from repro.data.pipeline import TokenPipeline as JPipeline
from repro_torch.data import TokenPipeline

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"w": (6, 5), "b": (5,), "emb": (7, 3)}


def _params(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _schedule(pkg):
    return pkg.linear_warmup_cosine(0.1, warmup=2, total_steps=6, floor=0.01)


OPTIMIZERS = {
    "sgd": lambda pkg: pkg.sgd(0.05),
    "sgd-scheduled": lambda pkg: pkg.sgd(_schedule(pkg)),
    "momentum": lambda pkg: pkg.momentum_sgd(0.05, mu=0.8),
    "momentum-scheduled": lambda pkg: pkg.momentum_sgd(_schedule(pkg)),
    "adam": lambda pkg: pkg.adam(1e-2),
    "adam-decay": lambda pkg: pkg.adam(1e-2, weight_decay=0.1),
    "adam-scheduled": lambda pkg: pkg.adam(_schedule(pkg), b1=0.8,
                                           weight_decay=0.05),
}


@pytest.mark.parametrize("clip", [None, 0.5], ids=["raw", "clipped"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_repro(name, clip):
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    start = _params(0)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for step in range(5):
        g = _params(100 + step)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        if clip is not None:
            jg, jn = jopt.clip_by_global_norm(jg, clip)
            tg, tn = topt.clip_by_global_norm(tg, clip)
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       err_msg=f"{name} step {step} {k}",
                                       **TOL)
            for moment in ("m", "v"):
                if moment in js:
                    np.testing.assert_allclose(
                        ts[moment][k].numpy(), np.asarray(js[moment][k]),
                        err_msg=f"{name} step {step} {moment}.{k}", **TOL)


SCHEDULES = {
    "constant": lambda pkg: pkg.constant(0.3),
    "cosine": lambda pkg: pkg.cosine_decay(0.3, total_steps=8, floor=0.02),
    "warmup-cosine": lambda pkg: pkg.linear_warmup_cosine(
        0.3, warmup=4, total_steps=10, floor=0.01),
    "no-warmup": lambda pkg: pkg.linear_warmup_cosine(0.3, warmup=0,
                                                      total_steps=5),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_repro(name):
    """Steps 0-12, past the end of every decay; at ``step == warmup`` both
    take the cosine branch (``repro``'s ``where(step < warmup, ...)``)."""
    jf, tf = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    for step in range(13):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                   err_msg=f"{name} step {step}")
    if name == "warmup-cosine":
        boundary = tf(torch.tensor(4, dtype=torch.int32))
        assert float(boundary) == pytest.approx(0.3, rel=1e-6)


def test_global_norm_matches_repro():
    g = _params(7)
    jn = jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    tn = topt.global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_pipeline_is_repro_bitwise(seed):
    corpus = np.random.default_rng(9).integers(
        0, 1000, (12, 70)).astype(np.int32)
    jpipe, tpipe = JPipeline(corpus, 4, 32, seed), TokenPipeline(corpus, 4,
                                                                 32, seed)
    for _ in range(5):
        want, got = next(jpipe), next(tpipe)
        assert got.shape == (4, 33) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_token_pipeline_rejects_short_rows():
    with pytest.raises(ValueError, match="seq_len"):
        TokenPipeline(np.zeros((3, 8), np.int32), 2, 8)
