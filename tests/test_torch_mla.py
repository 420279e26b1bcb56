"""The port's multi-head latent attention (``repro_torch.models.attention``
``MLA``) against ``repro``'s on reduced deepseek-v2-lite-16b (4 heads,
latent 64, q/k heads 32 + 16 wide, v 32) with the same numpy weights and
inputs: ``mla_fwd`` below ``BLOCKED_SDPA_THRESHOLD`` (dense scores) and
above it (q blocks of ``SDPA_BLOCK_Q``), and ``mla_decode`` in its naive
and absorbed forms at scalar positions and at one position per sequence
in turns, writing the latent cache in place.

Both sides f32 on the CPU: outputs and caches atol 1e-5 / rtol 1e-5."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import transformer as jT
from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as tattn
from test_torch_moe import load

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "deepseek-v2-lite-16b"


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    jp = jattn.init_mla(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, load(tattn.MLA(tcfg, device="cpu"), tree)


def mla_pair(absorb=False):
    """(repro cfg, repro params, port cfg, port MLA): one weight set, the
    decode form chosen by ``mla_absorb``."""
    jp, tp = _weights()
    return (jget_config(ARCH).reduced().variant(mla_absorb=absorb), jp,
            tget_config(ARCH).reduced().variant(mla_absorb=absorb), tp)


def inputs(cfg, B, S, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("S", [40, 1152])
def test_mla_fwd_matches_repro(S):
    """S 40: one dense score block; S 1152 (past the threshold of 1024, 9
    blocks of 128): the q-blocked schedule."""
    jcfg, jp, tcfg, tp = mla_pair()
    assert (S > tattn.BLOCKED_SDPA_THRESHOLD) == (S == 1152)
    x = inputs(tcfg, 1, S, 5)
    pos = np.arange(S, dtype=np.int32)
    jy, jc = jax.jit(lambda p, v: jattn.mla_fwd(jcfg, p, v,
                                                jnp.asarray(pos)))(jp, x)
    ty, tc = tattn.mla_fwd(tcfg, tp, torch.from_numpy(x),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_mla_decode_matches_repro(absorb):
    """A 12-token prefill grown to 20 positions, then four decode steps at
    a scalar position and at one position per sequence in turns (12,
    [13, 8], 14, [15, 10]); every step's output and the whole cache after
    it."""
    jcfg, jp, tcfg, tp = mla_pair(absorb)
    B, P, S = 2, 12, 20
    x = inputs(tcfg, B, P, 6)
    pos = np.arange(P, dtype=np.int32)
    _, jc = jax.jit(lambda p, v, q: jattn.mla_fwd(jcfg, p, v, q))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    jc = {k: jnp.pad(v, ((0, 0), (0, S - P), (0, 0))) for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    decode = jax.jit(lambda p, v, c, q: jattn.mla_decode(jcfg, p, v, c, q))
    for i in range(4):
        step = np.array([P + i, P - 5 + i] if i % 2 else P + i, np.int32)
        xt = inputs(tcfg, B, 1, 10 + i)
        jy, jc = decode(jp, jnp.asarray(xt), jc, jnp.asarray(step))
        ty, tc2 = tattn.mla_decode(tcfg, tp, torch.from_numpy(xt), tc,
                                   torch.from_numpy(step))
        assert tc2 is tc                                  # written in place
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   err_msg=f"step {i}", **TOL)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       err_msg=f"step {i} {k}", **TOL)


def test_absorbed_decode_equals_naive():
    """The two decode forms are one function: within f32 rounding."""
    _, _, tcfg, tp = mla_pair()
    B, S = 2, 16
    cache = tattn.init_mla_cache(tcfg, B, S, torch.float32, "cpu")
    x = torch.from_numpy(inputs(tcfg, B, 1, 7))
    outs = []
    for absorb in (False, True):
        c = {k: v.clone() for k, v in cache.items()}
        cfg = tcfg.variant(mla_absorb=absorb)
        for i in range(4):
            y, c = tattn.mla_decode(cfg, tp, x * (i + 1), c, i)
        outs.append(y)
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), **TOL)


def test_mla_cache_shapes_equal_repro():
    jcfg, _, tcfg, _ = mla_pair()
    want = jT.init_cache(jcfg, 3, 40)
    got = tattn.init_mla_cache(tcfg, 3, 40, torch.float32, "cpu")
    for k, v in got.items():
        assert tuple(v.shape) == want["stack"]["sub0"]["mixer"][k].shape[1:]
