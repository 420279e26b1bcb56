"""The packed flat layout and the fused chain: the port's ``ParamLayout``,
``ring_agg`` (plain version and the wrapper on CPU tensors),
``prefix_weights`` and ``chain_coeffs`` against ``repro``'s.

Tolerances: the layout, pack/unpack and the prefix weights are exact.  The
chain is U sequential f32 mixes; JAX's scan oracle and the Pallas kernel
(interpret mode) are compiled by XLA:CPU, which may contract a mix into an
FMA (DESIGN.md §12), skipping one rounding per step, so the two sides agree
to at most U f32 ulps of the largest magnitude the chain touches.
``chain_coeffs`` are the same f32 expressions; ``pow`` may differ by one
ulp between the two libraries."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.aggregation as jagg
from repro.core.flat import ParamLayout as JLayout
from repro.kernels.weighted_agg import ops as jops
from repro.kernels.weighted_agg import ref as jref
from repro.kernels.weighted_agg.kernel import LANE, ring_agg_2d
from repro.models.cnn import init_cnn as jinit_cnn
from repro_torch import kernels
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import chain_coeffs
from repro_torch.core.flat import ParamLayout
from repro_torch.kernels.weighted_agg import ops, ref
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

P_RAGGED = LANE * 300          # not a multiple of any power-of-two tile
U_CASES = [0, 1, 2, 7, 9]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(scope="module")
def jtree():
    return jinit_cnn(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ttree(jtree):
    return params_from_jax({k: np.asarray(v) for k, v in jtree.items()},
                           "cpu")


def test_layout_equals_repro(jtree, ttree):
    jl, tl = JLayout.from_tree(jtree), ParamLayout.from_tree(ttree)
    assert tl.names == jl.names == ("conv1_b", "conv1_w", "conv2_b",
                                    "conv2_w", "fc1_b", "fc1_w", "fc2_b",
                                    "fc2_w")
    assert tl.offsets == jl.offsets == (0, 128, 512, 640, 19072, 19200,
                                        420608, 420736)
    assert tl.P == jl.P == 422016
    assert (tl.shapes, tl.dtypes, tl.sizes) == (jl.shapes, jl.dtypes,
                                                jl.sizes)
    assert tl.to_json() == jl.to_json()
    assert tl.nbytes_f32 == jl.nbytes_f32


def test_layout_json_crosses_packages(jtree, ttree):
    jl, tl = JLayout.from_tree(jtree), ParamLayout.from_tree(ttree)
    assert ParamLayout.from_json(jl.to_json()).signature() == tl.signature()
    assert JLayout.from_json(tl.to_json()).signature() == jl.signature()
    # a nested tree whose sorted order differs from the stored one
    nested = {"b": {"10": torch.zeros(3), "2": torch.ones(2, 2)},
              "a": torch.arange(5.0)}
    lay = ParamLayout.from_tree(nested)
    assert lay.names == ("a", "b/10", "b/2")
    back = ParamLayout.from_json(lay.to_json())
    assert back.signature() == lay.signature()
    assert (JLayout.from_json(lay.to_json()).signature()
            == lay.signature())
    out = back.unpack(lay.pack(nested))
    assert torch.equal(out["b"]["2"], nested["b"]["2"])


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["unbatched", "batch3"])
def test_pack_unpack_roundtrip_is_bitwise(ttree, batch):
    rng = np.random.default_rng(1)
    tree = {k: torch.from_numpy(rng.normal(size=batch + tuple(v.shape))
                                .astype(np.float32))
            for k, v in ttree.items()}
    lay = ParamLayout.from_tree(ttree)
    flat = lay.pack(tree)
    assert flat.shape == batch + (lay.P,) and flat.dtype == torch.float32
    out = lay.unpack(flat)
    for k, v in tree.items():
        assert out[k].shape == v.shape
        assert torch.equal(_bits(out[k]), _bits(v))
    # gaps and padding stay zero
    used = torch.zeros(lay.P, dtype=torch.bool)
    for off, size in zip(lay.offsets, lay.sizes):
        used[off:off + size] = True
    assert not flat[..., ~used].any()
    # the same buffer as repro's pack
    jflat = JLayout.from_tree({k: jnp.asarray(v.numpy())
                               for k, v in ttree.items()}).pack(
        {k: jnp.asarray(v.numpy()) for k, v in tree.items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))


def test_bf16_pack_unpacks_to_f32(ttree):
    lay = ParamLayout.from_tree(ttree)
    flat = lay.pack(ttree, dtype=torch.bfloat16)
    assert flat.dtype == torch.bfloat16
    out = lay.unpack(flat)
    jl = JLayout.from_tree({k: jnp.asarray(v.numpy())
                            for k, v in ttree.items()})
    jout = jl.unpack(jl.pack({k: jnp.asarray(v.numpy())
                              for k, v in ttree.items()},
                             dtype=jnp.bfloat16))
    for k, v in ttree.items():
        assert out[k].dtype == torch.float32
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
        torch.testing.assert_close(out[k], v, rtol=2 ** -8, atol=0.0)


def _chain_inputs(U, jdt, tdt, seed, neg_zero=False):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=P_RAGGED).astype(np.float32)
    locs = rng.normal(size=(U, P_RAGGED)).astype(np.float32)
    c = rng.uniform(0.5, 1.0, size=U).astype(np.float32)
    coeffs = np.stack([c, (1.0 - c).astype(np.float32)], 1)
    if neg_zero:
        g[::7] = -0.0
        if U:
            locs[:, ::7] = 0.0
            coeffs[0] = (1.0, 0.0)
    jl = jnp.asarray(locs, jdt)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(tdt)
    return (jnp.asarray(g), jl, jnp.asarray(coeffs),
            torch.from_numpy(g), tl, torch.from_numpy(coeffs))


def _ulp_bound(U, g, locs, got):
    top = max(np.abs(g).max(), np.abs(np.asarray(locs, np.float32)).max(),
              np.abs(got).max())
    return U * np.spacing(np.float32(top))


@pytest.mark.parametrize("jdt, tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("U", U_CASES)
@pytest.mark.parametrize("neg_zero", [False, True], ids=["", "negzero"])
def test_ring_agg_matches_repro(jdt, tdt, U, neg_zero):
    jg, jl, jc, tg, tl, tc = _chain_inputs(U, jdt, tdt, seed=U,
                                           neg_zero=neg_zero)
    kernels.reset_launches()
    got = ops.ring_agg(tg, tl, tc)
    assert kernels.launch_counts()["ring_agg"] == 0
    assert got.dtype == torch.float32 and got.shape == (P_RAGGED,)
    plain = ref.ring_agg(tg, tl, tc)
    assert torch.equal(_bits(got), _bits(plain))
    assert got.data_ptr() != tg.data_ptr()          # a new tensor, always
    got = got.numpy()
    if U == 0:
        np.testing.assert_array_equal(got.view(np.int32),
                                      tg.numpy().view(np.int32))
        np.testing.assert_array_equal(
            got, np.asarray(jops.ring_agg(jg, jl, jc)))
        return
    tol = _ulp_bound(U, tg.numpy(), tl.float().numpy(), got)
    want = np.asarray(jref.ring_agg(jg, jl, jc))
    assert np.abs(got - want).max() <= tol
    pallas = np.asarray(ring_agg_2d(
        jg.reshape(-1, LANE), jl.reshape(U, -1, LANE), jc, block_rows=64,
        block_u=4, interpret=True)).reshape(-1)
    assert np.abs(got - pallas).max() <= tol


def test_ring_agg_signed_zero_follows_the_arithmetic():
    """A (1, 0) step maps -0.0 to +0.0 (c*acc + d*l = -0 + +0): the chain
    runs exactly U plain steps, no masking."""
    g = torch.full((LANE,), -0.0)
    locs = torch.ones((2, LANE))
    coeffs = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    assert torch.signbit(ops.ring_agg(g, locs[:0], coeffs[:0])).all()
    out = ops.ring_agg(g, locs, coeffs)
    assert not torch.signbit(out).any() and not out.any()


@pytest.mark.parametrize("case", ["P", "locs_shape", "locs_noncontig",
                                  "locs_f16", "g_bf16", "coeffs_shape",
                                  "coeffs_f64", "g_2d"])
def test_ring_agg_wrapper_rejects_bad_inputs(case):
    P, U = 2 * LANE, 3
    g, locs, co = torch.zeros(P), torch.zeros(U, P), torch.zeros(U, 2)
    bad = {
        "P": (torch.zeros(P - 8), torch.zeros(U, P - 8), co),
        "locs_shape": (g, torch.zeros(U, P + LANE), co),
        "locs_noncontig": (g, torch.zeros(P, U).t(), co),
        "locs_f16": (g, locs.half(), co),
        "g_bf16": (g.bfloat16(), locs, co),
        "coeffs_shape": (g, locs, torch.zeros(U + 1, 2)),
        "coeffs_f64": (g, locs, co.double()),
        "g_2d": (g.view(2, LANE), locs, co),
    }[case]
    kernels.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        ops.ring_agg(*bad)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}


@pytest.mark.parametrize("U", [1, 4, 9])
def test_prefix_weights_equal_repro(U):
    rng = np.random.default_rng(U)
    c = rng.uniform(0.0, 1.0, size=(U, 2)).astype(np.float32)
    np.testing.assert_array_equal(ops.prefix_weights(torch.from_numpy(c)),
                                  jops.prefix_weights(jnp.asarray(c)))


@pytest.mark.parametrize("scheme, interpretation", [
    ("mafl", "mixing"), ("mafl", "literal"), ("afl", "mixing"),
    ("fedasync", "mixing")])
@pytest.mark.parametrize("beta", [0.5, 0.3, 0.9])
def test_chain_coeffs_equal_repro(scheme, interpretation, beta):
    rng = np.random.default_rng(7)
    w = rng.uniform(0.3, 3.5, size=40).astype(np.float32)
    t = np.sort(rng.uniform(1.0, 90.0, size=40)).astype(np.float32)
    dl = (t - rng.uniform(-2.0, 30.0, size=40)).astype(np.float32)
    jc, jd = jagg.chain_coeffs(scheme, interpretation, beta, jnp.asarray(w),
                               t=jnp.asarray(t), dl_t=jnp.asarray(dl),
                               fedasync_mix=0.5)
    tc, td = chain_coeffs(scheme, interpretation, beta, torch.from_numpy(w),
                          t=torch.from_numpy(t), dl_t=torch.from_numpy(dl),
                          fedasync_mix=0.5)
    for got, want in ((tc, jc), (td, jd)):
        assert got.dtype == torch.float32
        want = np.asarray(want, np.float32)
        assert (np.abs(got.numpy() - want) <= np.spacing(want)).all()


def test_chain_coeffs_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="fedbuff"):
        chain_coeffs("fedbuff", "mixing", 0.5, torch.ones(2))
