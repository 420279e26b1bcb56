"""K4 decode attention: the port's plain version (the CPU path of
``repro_torch.kernels.decode_attention.ops``) against ``repro``'s oracle,
its Pallas kernel in interpret mode and ``attention_decode`` with a
position per sequence, on the same numpy inputs.

Tolerances: f32 atol 1e-5 — the same function, summed in another order by
two CPU libraries (ulps on scores of size ~10).  bf16 atol 3e-2, the band
of ``repro``'s own bf16 kernel test: scores and weights round to bf16 at
places the two frameworks choose differently."""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention import ref as jref
from repro_torch.kernels.decode_attention import ops, ref
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = {"f32": 1e-5, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, S, H, Kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, hd)).astype(np.float32),
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
    (1, 64, 3, 3, 64),        # G = 1
    (2, 128, 6, 2, 64),       # G = 3, smollm's grouping
    (2, 96, 3, 1, 32),        # G = 3, S not a power of two
])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_plain_matches_repro_ref(dt, B, S, H, Kv, hd, where):
    pos = {"first": 0, "middle": S // 2, "last": S - 1}[where]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, Kv, hd), dt)
    want = jref.decode_attention(jq, jk, jv, pos)
    got = ops.decode_attention(tq, tk, tv, pos)
    assert got.dtype == TDT[dt] and got.shape == (B, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("pos", [0, 37, 127])
def test_plain_matches_repro_interpret_kernel(G, pos):
    B, S, Kv, hd = 2, 128, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, G * Kv, Kv, hd, 1),
                                       "f32")
    want = jops.decode_attention(jq, jk, jv, pos, block_s=64,
                                 interpret=True)
    got = ops.decode_attention(tq, tk, tv, pos)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["f32"], rtol=0)


def test_plain_matches_repro_interpret_kernel_bf16():
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 64, 6, 2, 64, 2), "bf16")
    want = jops.decode_attention(jq, jk, jv, 40, block_s=32, interpret=True)
    got = ops.decode_attention(tq, tk, tv, 40)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bf16"],
                               rtol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_per_row_positions_match_repro_rows(dt):
    """A pos vector gives each row what a scalar pos gives that row."""
    B, S, H, Kv, hd = 3, 64, 6, 2, 64
    pos = np.array([0, 31, 63])
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, Kv, hd, 3), dt)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    assert got.shape == (B, H, hd)
    for b in range(B):
        want = jref.decode_attention(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1],
                                     int(pos[b]))
        np.testing.assert_allclose(_np(got[b:b + 1]), _np(want),
                                   atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("G", [1, 3])
def test_per_row_positions_match_repro_attention_decode(G):
    """The port's ``attention_decode`` (K4's plain version inside) against
    ``repro``'s with the same weights, cache and a pos vector: the output
    and the written cache."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import attention as jattn
    from repro_torch.configs import get_config
    from repro_torch.models import attention as tattn

    kw = dict(n_heads=2 * G, n_kv_heads=2)
    jcfg = jget_config("smollm-360m").reduced().variant(**kw)
    tcfg = get_config("smollm-360m").reduced().variant(**kw)
    jp = jattn.init_attention(jcfg, jax.random.PRNGKey(G), jnp.float32)
    tp = tattn.Attention(tcfg, device="cpu")
    for name, leaf in jp.items():
        getattr(tp, name).copy_(torch.from_numpy(np.array(leaf)))
    rng = np.random.default_rng(G)
    B, S = 3, 48
    hd = tcfg.resolved_head_dim
    cache = {k: rng.normal(size=(B, S, 2, hd)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([5, 47, 0], np.int32)
    jy, jc = jattn.attention_decode(
        jcfg, jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                   cache.items()}, jnp.asarray(pos))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, tc = tattn.attention_decode(tcfg, tp, torch.from_numpy(x), tc,
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-5, rtol=0)


def test_split_covers_the_sequence():
    """The kernel's sequence split: n_chunks blocks per (b, kv head), from
    the shapes alone, enough for WAVE_BLOCKS blocks at small batch, at
    most one chunk a kv tile and MAX_CHUNKS in all."""
    for B, S, Kv in [(8, 2048, 5), (4, 1024, 5), (128, 32768, 5),
                     (1, 100, 1), (2, 64, 2), (8, 32768, 5),
                     (1, 1 << 20, 1)]:
        n = ops.split(B, S, Kv)
        assert 1 <= n <= min(-(-S // ops.KV_TILE), ops.MAX_CHUNKS)
        assert (n == -(-S // ops.KV_TILE) or n == ops.MAX_CHUNKS
                or B * Kv * n >= ops.WAVE_BLOCKS)
    assert ops.split(8, 2048, 5) == 32             # serve: one tile a chunk
    assert ops.split(128, 32768, 5) == 4           # decode_32k: 2,560 blocks
    assert ops.split(1024, 32768, 5) == 1


def _covered(starts, stops, live):
    """Asserts that the shares of one row tile [0, live) in order, whole
    kv tiles but the last live one, and that the rest are empty at live."""
    per = stops[0] - starts[0]
    assert per > 0 and (per % ops.KV_TILE == 0 or per == live)
    at = 0
    for a, z in zip(starts, stops):
        if at == live:
            assert a == z == live
            continue
        assert a == at and a % ops.KV_TILE == 0 and a < z <= live
        assert z - a == per or z == live
        at = z
    assert at == live


@pytest.mark.parametrize("S, n_chunks", [(2048, 32), (2048, 5), (130, 3),
                                         (32768, 4), (64, 1)])
def test_chunk_bounds_cover_the_live_prefix(S, n_chunks):
    """Each row's shares cover [0, pos] exactly once in tile-aligned
    pieces of roundup(ceil(live / n_chunks), 64) positions."""
    rng = np.random.default_rng(S + n_chunks)
    edge = np.array([0, 1, 63, 64, 65, S - 1])
    for pos in (edge, rng.integers(0, S, 16)):
        starts, stops = ops.chunk_bounds(pos, S, n_chunks)
        assert starts.shape == stops.shape == (len(pos), n_chunks)
        for p, a, z in zip(pos, starts, stops):
            live = min(int(p) + 1, S)
            _covered(a, z, live)
            per = -(-live // n_chunks)
            assert z[0] - a[0] == min(-(-per // 64) * 64, live)
    a, z = ops.chunk_bounds(S - 1, S, n_chunks)     # a scalar pos
    _covered(a, z, S)


def _split_combine(q, k, v, pos, n_chunks):
    """K4's algorithm in plain torch: the partial state (m, l, acc) of each
    share of ``ops.chunk_bounds`` in log2 units, the weights rounded to the
    inputs' dtype before P @ V as the kernel rounds them, empty shares
    neutral (-1e30, 0, 0); then the combine."""
    B, H, hd = q.shape
    S, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.float().reshape(B, Kv, G, hd)
    starts, stops = ops.chunk_bounds(np.broadcast_to(pos, (B,)), S,
                                     n_chunks)
    scale = math.log2(math.e) / math.sqrt(hd)
    out = torch.empty(B, Kv, G, hd)
    for b in range(B):
        ms, ls, accs = [], [], []
        for a, z in zip(starts[b], stops[b]):
            if a == z:
                ms.append(torch.full((Kv, G), -1e30))
                ls.append(torch.zeros(Kv, G))
                accs.append(torch.zeros(Kv, G, hd))
                continue
            s = torch.einsum("kgh,tkh->kgt", qg[b], k[b, a:z].float()) * scale
            m = s.amax(-1)
            w = torch.exp2(s - m[..., None])
            ms.append(m)
            ls.append(w.sum(-1))
            accs.append(torch.einsum("kgt,tkh->kgh", w.to(q.dtype).float(),
                                     v[b, a:z].float()))
        m = torch.stack(ms)
        wt = torch.exp2(m - m.amax(0))
        l = (wt * torch.stack(ls)).sum(0)
        acc = (wt[..., None] * torch.stack(accs)).sum(0)
        out[b] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 63, 64, 65, 127])
def test_split_and_combine_matches_repro_interpret_kernel(dt, pos):
    """The kernel's split of the live prefix and its combine, in plain
    torch, against repro's Pallas kernel in interpret mode, at the kv
    tile's edges and for one, two and five chunks."""
    B, S, H, Kv, hd = 2, 128, 6, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, H, Kv, hd, pos), dt)
    want = _np(jops.decode_attention(jq, jk, jv, pos, block_s=64,
                                     interpret=True))
    assert ops.split(B, S, Kv) == 2
    for n_chunks in (1, 2, 5):
        got = _split_combine(tq, tk, tv, pos, n_chunks)
        assert got.dtype == TDT[dt] and got.shape == (B, H, hd)
        np.testing.assert_allclose(_np(got), want, atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "group", "pos"])
def test_wrapper_rejects(bad):
    q = torch.zeros(2, 6, 64)
    k = torch.zeros(2, 16, 2, 64)
    args = {"shape": (q, k[:, :, :, :32], k[:, :, :, :32], 0),
            "dtype": (q.double(), k.double(), k.double(), 0),
            "group": (torch.zeros(2, 5, 64), k, k, 0),
            "pos": (q, k, k, torch.zeros(3, dtype=torch.int32))}[bad]
    with pytest.raises((ValueError, TypeError)):
        ops.decode_attention(*args)
