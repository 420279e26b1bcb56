"""Shared by the port's slice tests: one world run through ``repro`` and
``repro_torch`` from the same (JAX-drawn) init, and the comparison.

Tolerances of the host engines: the (round, vehicle) trace is host f64 and
must be identical, event times and delay weights equal to rtol 1e-9.
Parameters: both sides train in f32, but the convolutions sum in different
orders (and XLA contracts some multiply-adds into FMAs), a few ulps per op
that SGD carries from round to round — about 4e-7 absolute after 8
paper-k10 rounds — so final params are held to atol 2e-5 / rtol 1e-4.
Accuracy within 0.02, the golden suite's bar.  The fleet engine's bands are
stated beside ``assert_fleet_conforms``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import repro.core.mafl as jmafl
import repro.core.scenarios as jsc
import repro.models.cnn as jcnn
import repro_torch.core.mafl as tmafl
import repro_torch.core.scenarios as tsc
from repro_torch.convert import params_from_jax, params_to_numpy

PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
ACC_TOL = 0.02


def jax_init(seed: int = 0) -> dict[str, np.ndarray]:
    """repro's CNN init as numpy leaves."""
    return {k: np.asarray(v)
            for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed)).items()}


def run_both(name, init, **kw):
    sc = jsc.get_scenario(name)
    jveh, jti, jtl, jp = jsc.build_world(sc)
    tveh, tti, ttl, tp = tsc.build_world(tsc.get_scenario(name))
    common = dict(scheme=sc.scheme, l_iters=sc.l_iters, lr=sc.lr, seed=0,
                  eval_every=2, use_kernel=True)
    common.update(kw)
    jres = jmafl.run_simulation(
        jveh, jti, jtl, params=jp,
        init_params={k: jnp.asarray(v) for k, v in init.items()}, **common)
    tres = tmafl.run_simulation(
        tveh, tti, ttl, params=tp, init_params=params_from_jax(init, "cpu"),
        device="cpu", **common)
    return jres, tres


def assert_conforms(jres, tres):
    assert ([(r.round, r.vehicle) for r in jres.rounds]
            == [(r.round, r.vehicle) for r in tres.rounds])
    for a, b in zip(jres.rounds, tres.rounds):
        np.testing.assert_allclose(
            [b.time, b.upload_delay, b.train_delay, b.weight],
            [a.time, a.upload_delay, a.train_delay, a.weight], rtol=1e-9)
    tnp = params_to_numpy(tres.final_params)
    for k, v in jres.final_params.items():
        assert tres.final_params[k].device.type == "cpu"
        np.testing.assert_allclose(tnp[k], np.asarray(v), err_msg=k,
                                   **PARAM_TOL)
    assert [r for r, _ in jres.acc_history] == [r for r, _ in
                                                tres.acc_history]
    for (_, a), (_, b) in zip(jres.acc_history, tres.acc_history):
        assert abs(a - b) <= ACC_TOL
        assert np.isfinite(b)


# engine="jit" against repro's engine="jit": event times, delays and weights
# are f32 device arithmetic on both sides, held to the f32 band of
# tests/test_engine_conformance.py; with a bf16 ring one stored bf16 row
# element may round the other way (2^-8 relative), so params get 1e-2.
FLEET_TIME_TOL = dict(rtol=2e-5, atol=1e-3)
FLEET_WEIGHT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_PARAM_TOL = dict(rtol=0.0, atol=1e-2)


def assert_fleet_conforms(jres, tres, bf16: bool = False):
    assert ([(r.round, r.vehicle) for r in jres.rounds]
            == [(r.round, r.vehicle) for r in tres.rounds])
    for a, b in zip(jres.rounds, tres.rounds):
        np.testing.assert_allclose(
            [b.time, b.upload_delay, b.train_delay],
            [a.time, a.upload_delay, a.train_delay], **FLEET_TIME_TOL)
        np.testing.assert_allclose(b.weight, a.weight, **FLEET_WEIGHT_TOL)
    tnp = params_to_numpy(tres.final_params)
    for k, v in jres.final_params.items():
        assert tres.final_params[k].device.type == "cpu"
        np.testing.assert_allclose(
            tnp[k], np.asarray(v), err_msg=k,
            **(BF16_PARAM_TOL if bf16 else PARAM_TOL))
    assert [r for r, _ in jres.acc_history] == [r for r, _ in
                                                tres.acc_history]
    for (_, a), (_, b) in zip(jres.acc_history, tres.acc_history):
        assert abs(a - b) <= ACC_TOL
        assert np.isfinite(b)


def transformer_pair(variant: dict | None = None, seed: int = 0):
    """smollm-360m reduced (optionally a ``variant`` of it) in both
    packages with ``repro``'s ``T.init_params`` weights: returns
    ``(jax cfg, jax params, port cfg, port model on the CPU)``."""
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jT
    from repro_torch.configs import get_config as tget_config
    from repro_torch.convert import transformer_params_from_jax

    jcfg = jget_config("smollm-360m").reduced().variant(**(variant or {}))
    tcfg = tget_config("smollm-360m").reduced().variant(**(variant or {}))
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, transformer_params_from_jax(tree, tcfg,
                                                            "cpu")
