"""The port's MoE (``repro_torch.models.moe``) against ``repro.models.moe``
on the same numpy weights and inputs: the capacity dispatch of train and
prefill (``moe_fwd``) on reduced deepseek-v2-lite-16b (4 experts, top-2, a
shared expert) as configured and at ``capacity_factor=0.5``, where tokens
are certainly dropped; the dense-mask decode (``moe_decode``); and top-1
routing (reduced llama4-scout-17b-a16e).

Both sides f32 on the CPU, the expert products summed in different orders:
outputs atol 1e-5 / rtol 1e-5 (activations of size ~0.1-1), the aux loss
rtol 1e-5."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import _flatten
from repro_torch.models import moe as tmoe

pytestmark = pytest.mark.usefixtures("one_thread")

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=0, rtol=1e-5)
ARCHS = {"deepseek": "deepseek-v2-lite-16b", "scout": "llama4-scout-17b-a16e"}


def load(module, tree):
    """Copy ``repro``'s numpy leaves into ``module``'s parameters (same
    names, same shapes)."""
    flat = _flatten(tree)
    names = dict(module.named_parameters())
    assert set(flat) == set(names)
    for name, p in names.items():
        assert tuple(p.shape) == np.shape(flat[name]), name
        p.copy_(torch.from_numpy(np.array(flat[name])))
    return module


def moe_pair(arch, **overrides):
    """(repro cfg, repro params, port cfg, port MoE) on the same weights."""
    jcfg = jget_config(ARCHS[arch]).reduced().variant(**overrides)
    tcfg = tget_config(ARCHS[arch]).reduced().variant(**overrides)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tcfg, load(tmoe.MoE(tcfg, device="cpu"), tree)


def inputs(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch,cf", [("deepseek", None), ("deepseek", 0.5),
                                     ("scout", None)])
def test_moe_fwd_matches_repro(arch, cf):
    overrides = {} if cf is None else {"capacity_factor": cf}
    jcfg, jp, tcfg, tp = moe_pair(arch, **overrides)
    x = inputs(tcfg, 2, 24, 1)
    B, S, _ = x.shape
    if cf is not None:       # fewer slots than assignments: some drop
        assert tmoe.capacity(tcfg, S) * tcfg.n_routed_experts < \
            S * tcfg.moe_top_k
    jy, jaux = jax.jit(lambda p, v: jmoe.moe_fwd(jcfg, p, v))(jp, x)
    ty, taux = tmoe.moe_fwd(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


def test_dropped_tokens_change_the_output():
    """At ``capacity_factor=0.5`` the dropped assignments are missing from
    the output: it differs from the run with room for every token."""
    _, _, tcfg, tp = moe_pair("deepseek", capacity_factor=0.5)
    x = torch.from_numpy(inputs(tcfg, 2, 24, 1))
    tight, _ = tmoe.moe_fwd(tcfg, tp, x)
    roomy, _ = tmoe.moe_fwd(tcfg.variant(capacity_factor=4.0), tp, x)
    assert not torch.allclose(tight, roomy)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_decode_matches_repro(arch):
    jcfg, jp, tcfg, tp = moe_pair(arch)
    x = inputs(tcfg, 3, 1, 2)
    jy, jaux = jax.jit(lambda p, v: jmoe.moe_decode(jcfg, p, v))(jp, x)
    ty, taux = tmoe.moe_decode(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


def test_router_is_float32_in_a_bf16_model():
    _, _, tcfg, _ = moe_pair("deepseek")
    p = tmoe.MoE(tcfg, torch.bfloat16, "cpu")
    assert p.router.dtype == torch.float32
    assert p.w_gate.dtype == p.shared.w_gate.dtype == torch.bfloat16
    assert tuple(p.w_gate.shape) == (tcfg.n_routed_experts, tcfg.d_model,
                                     tcfg.moe_d_ff)
