"""K5 sliding-window attention: the port's plain version (the CPU path of
``repro_torch.kernels.swa_attention.ops``) against ``repro``'s oracle, its
Pallas kernel in interpret mode and ``repro``'s causal prefill attention,
on the same numpy inputs.  Tolerances as in
``test_torch_decode_attention.py``: f32 atol 1e-5, bf16 atol 3e-2."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention import ops as jops
from repro.kernels.swa_attention import ref as jref
from repro_torch.kernels.swa_attention import ops

TOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, S, H, Kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, Kv, hd)).astype(np.float32),
            rng.normal(size=(B, S, Kv, hd)).astype(np.float32))


def _both(arrays, dt):
    return ([jnp.asarray(a, JDT[dt]) for a in arrays],
            [torch.from_numpy(a).to(TDT[dt]) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Kv,hd", [
    (1, 64, 2, 2, 64),        # G = 1
    (2, 96, 6, 2, 64),        # G = 3, S = 96
    (1, 128, 3, 1, 32),       # G = 3
])
@pytest.mark.parametrize("window", ["S", 16, 33, 200])
def test_plain_matches_repro_ref(dt, B, S, H, Kv, hd, window):
    W = S if window == "S" else window
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, Kv, hd), dt)
    want = jref.swa_attention(jq, jk, jv, W)
    got = ops.swa_attention(tq, tk, tv, W)
    assert got.dtype == TDT[dt] and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("B,S,H,Kv,W,block", [
    (1, 96, 3, 1, 96, 32),      # causal (window = S), S = 96
    (1, 96, 3, 1, 33, 32),      # window not a multiple of the block
    (2, 64, 2, 2, 200, 32),     # window > S
    (1, 128, 6, 2, 64, 64),     # G = 3
])
def test_plain_matches_repro_interpret_kernel(B, S, H, Kv, W, block):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, Kv, 64, 1), "f32")
    want = jops.swa_attention(jq, jk, jv, W, block_q=block, block_k=block,
                              interpret=True)
    got = ops.swa_attention(tq, tk, tv, W)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["f32"], rtol=0)


def test_plain_matches_repro_interpret_kernel_bf16():
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 64, 6, 2, 64, 2), "bf16")
    want = jops.swa_attention(jq, jk, jv, 40, block_q=32, block_k=32,
                              interpret=True)
    got = ops.swa_attention(tq, tk, tv, 40)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bf16"],
                               rtol=0)


@pytest.mark.parametrize("S", [64, 96])
def test_window_s_is_repro_causal_prefill_attention(S):
    """``window = S`` is the function of ``repro``'s causal ``_sdpa_any``,
    the attention its prefill computes."""
    from repro.models.attention import _sdpa_any
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, S, 6, 2, 64, 3), "f32")
    want = _sdpa_any(jq, jk, jv, jnp.arange(S, dtype=jnp.int32), "full", 0)
    got = ops.swa_attention(tq, tk, tv, S)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["f32"], rtol=0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "group", "window"])
def test_wrapper_rejects(bad):
    q = torch.zeros(1, 8, 6, 64)
    k = torch.zeros(1, 8, 2, 64)
    args = {"shape": (q, k[:, :4], k[:, :4], 8),
            "dtype": (q.half(), k.half(), k.half(), 8),
            "group": (torch.zeros(1, 8, 5, 64), k, k, 8),
            "window": (q, k, k, 0)}[bad]
    with pytest.raises((ValueError, TypeError)):
        ops.swa_attention(*args)
