"""K4 at 16 query heads per kv head (llama3-405b: 128 over 8): the port's
plain version against ``repro``'s oracle on the same numpy inputs, at
both head dims, scalar and per-row positions; and the wrapper's groups
and launch geometry at G 16 (1..8 and 16 go to the kernel; that 9..15 are
refused on a card tensor is checked in ``test_torch_card.py``).

Tolerances as ``test_torch_decode_attention.py``: f32 atol 1e-5 (one
function summed in another order), bf16 atol 3e-2 (``repro``'s own bf16
band: the two frameworks round scores and weights at other places)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ref as jref
from repro_torch.kernels.decode_attention import ops
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pos", ["scalar", "rows"])
def test_plain_g16_matches_repro_ref(dt, hd, pos):
    B, S, Kv = 2, 136, 2
    H = 16 * Kv
    rng = np.random.default_rng(hd)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Kv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Kv, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dt]) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, JDT[dt]) for a in (q, k, v))
    positions = [S - 1, 70] if pos == "rows" else [S // 2] * B
    got = ops.decode_attention(
        tq, tk, tv, torch.tensor(positions, dtype=torch.int32)
        if pos == "rows" else positions[0])
    assert got.dtype == TDT[dt] and got.shape == (B, H, hd)
    for b, p in enumerate(positions):
        want = jref.decode_attention(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1],
                                     p)
        np.testing.assert_allclose(
            got[b:b + 1].float().numpy(),
            np.asarray(want.astype(jnp.float32)), atol=TOL[dt], rtol=0)


def test_groups_the_kernel_takes():
    assert ops.GROUPS == (1, 2, 3, 4, 5, 6, 7, 8, 16)
    assert ops.combine_threads(16) == 512 and ops.combine_threads(8) == 256
    # llama3-405b's decode shape: the chunk and combine launches' geometry
    geo = ops.geometry(2, 1056, 128, 8, 128)
    assert [g.threads for g in geo] == [ops.THREADS, 512]
    assert ops.part_size(2, 128, 128, ops.split(2, 1056, 8)) == \
        2 * 128 * ops.split(2, 1056, 8) * (128 + 4)
