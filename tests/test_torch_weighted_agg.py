"""The fused aggregation: the port's wrapper (plain version on CPU tensors)
against JAX's ``weighted_agg_2d`` (Pallas, interpret mode) and its jnp
oracle, plus the wrapper's checks and the kernel build's failure path.

Tolerances: the port's arithmetic is bitwise JAX's eager jnp oracle
(``repro.kernels.weighted_agg.ref``): both round beta*g, coef*l and their
sum separately.  The Pallas kernel run through the interpreter is compiled
by XLA:CPU, which may contract ``beta*g + coef*l`` into one FMA and so skip
one product's rounding: the two differ by at most one f32 ulp of the
larger term plus one ulp of the result in the storage type."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.weighted_agg import ops as jops
from repro.kernels.weighted_agg import ref as jref
from repro.kernels.weighted_agg.kernel import LANE, weighted_agg_2d
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.weighted_agg import ops, ref
from repro_torch.models.cnn import CNN_SHAPES

# mixing (1 - alpha, 1.0) and literal (beta, weight) scalar pairs
SCALARS = [(1.0 - 0.0734125, 1.0), (0.5, 0.8719), (0.3, 1.7)]
SIZES = [LANE * 37, 1000, 77]                 # lane multiple, ragged, < 128
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _inputs(n, jdt, tdt, seed):
    rng = np.random.default_rng(seed)
    g = jnp.asarray(rng.normal(size=n).astype(np.float32), jdt)
    l = jnp.asarray(rng.normal(size=n).astype(np.float32), jdt)
    to_t = (lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(tdt))
    return g, l, to_t(g), to_t(l)


def _assert_fma_close(got, pallas, g, l, beta, weight, jdt):
    """|got - pallas| <= ulp_f32(max term) + ulp_storage(result)."""
    b, coef = ref.agg_scalars(beta, weight)
    g = np.asarray(g, np.float32)
    l = np.asarray(l, np.float32)
    terms = np.maximum(np.abs(b * g), np.abs(coef * l)).astype(np.float32)
    ulp = np.spacing(np.abs(pallas)) * (2 ** 16 if jdt == jnp.bfloat16
                                        else 1)
    assert (np.abs(got - pallas) <= np.spacing(terms) + ulp).all()


@pytest.mark.parametrize("jdt, tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("beta, weight", SCALARS)
def test_plain_version_matches_jax(jdt, tdt, n, beta, weight):
    g, l, tg, tl = _inputs(n, jdt, tdt, seed=n)
    out = ops.weighted_agg(tg, tl, beta, weight)
    assert out.dtype == tdt and out.shape == tg.shape
    got = out.float().numpy()
    # bitwise against the port's own plain version and JAX's jnp oracle
    np.testing.assert_array_equal(
        got, ref.weighted_agg(tg, tl, beta, weight).float().numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jref.weighted_agg(g, l, beta, weight)
                        .astype(jnp.float32)))
    # within 1 ulp of the Pallas kernel (interpret mode); the lane-aligned
    # size calls weighted_agg_2d itself, the others go through repro's
    # padding wrapper
    if n % LANE == 0:
        scal = jnp.asarray([[beta, weight]], jnp.float32)
        pallas = weighted_agg_2d(g.reshape(-1, LANE), l.reshape(-1, LANE),
                                 scal, block_rows=16, interpret=True)
    else:
        pallas = jops.weighted_agg_leaf(g, l, beta, weight, interpret=True)
    pallas = np.asarray(pallas.reshape(-1).astype(jnp.float32))
    _assert_fma_close(got, pallas, g.astype(jnp.float32),
                      l.astype(jnp.float32), beta, weight, jdt)


def test_scalars_round_in_the_jax_kernel_order():
    for beta, weight in SCALARS:
        b32 = jnp.float32(beta)
        assert ref.agg_scalars(beta, weight) == (
            float(b32), float((1.0 - b32) * jnp.float32(weight)))


def test_tree_over_cnn_leaves_and_no_launch_on_cpu():
    rng = np.random.default_rng(0)
    g = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for k, s in CNN_SHAPES.items()}
    l = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for k, s in CNN_SHAPES.items()}
    kernels.reset_launches()
    out = ops.weighted_agg_tree(g, l, 0.9, 1.0)
    assert kernels.launch_counts() == {
        "weighted_agg": 0, "ring_agg": 0, "decode_attention": 0,
        "swa_attention": 0, "cross_entropy": 0}
    jout = jops.weighted_agg_tree({k: jnp.asarray(v.numpy())
                                   for k, v in g.items()},
                                  {k: jnp.asarray(v.numpy())
                                   for k, v in l.items()}, 0.9, 1.0,
                                  interpret=True)
    for k in g:
        assert out[k].shape == g[k].shape
        _assert_fma_close(out[k].numpy(), np.asarray(jout[k]), g[k], l[k],
                          0.9, 1.0, jnp.float32)


def _reduced_smollm_leaf_shape():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    model = T.Transformer(get_config("smollm-360m").reduced(), torch.float32,
                          "meta")
    return tuple(T.param_dict(model)["stack.0.sub0.mlp.w_gate"].shape)


# one merge's leaf set: 1, a ragged leaf under a lane, one lane, a ragged
# leaf over a block, a paper-CNN leaf and a reduced-smollm leaf
TREE_SHAPES = {"one": (1,), "ragged": (77,), "lane": (LANE,),
               "n12345": (12345,), "conv2_w": CNN_SHAPES["conv2_w"],
               "w_gate": _reduced_smollm_leaf_shape()}


@pytest.mark.parametrize("jdt, tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("beta, weight", SCALARS[:2])
def test_tree_matches_repro_pallas_tree(jdt, tdt, beta, weight):
    """The whole merge against ``repro``'s ``weighted_agg_tree`` (Pallas,
    interpret mode) leaf by leaf, and bitwise against its jnp oracle."""
    rng = np.random.default_rng(7)
    jg, jl, tg, tl = {}, {}, {}, {}
    for k, shape in TREE_SHAPES.items():
        for jd, td in ((jg, tg), (jl, tl)):
            x = jnp.asarray(rng.normal(size=shape).astype(np.float32), jdt)
            jd[k] = x
            td[k] = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    out = ops.weighted_agg_tree(tg, tl, beta, weight)
    pallas = jops.weighted_agg_tree(jg, jl, beta, weight, interpret=True)
    assert list(out) == list(TREE_SHAPES)
    for k in TREE_SHAPES:
        assert out[k].dtype == tdt and out[k].shape == TREE_SHAPES[k]
        got = out[k].float().numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jref.weighted_agg(jg[k], jl[k], beta, weight)
                            .astype(jnp.float32)))
        _assert_fma_close(got, np.asarray(pallas[k].astype(jnp.float32)),
                          jg[k].astype(jnp.float32),
                          jl[k].astype(jnp.float32), beta, weight, jdt)


def test_flat_layout_starts_every_leaf_16_byte_aligned():
    assert ops.flat_layout([1, 77, 0, 128, 5], torch.float32) == (
        [0, 4, 84, 84, 212], 220)
    assert ops.flat_layout([1, 77, 0, 128, 5], torch.bfloat16) == (
        [0, 8, 88, 88, 216], 224)
    assert ops.launches(0) == 0 and ops.launches(1) == 1
    assert ops.launches(ops.MAX_LEAVES) == 1
    assert ops.launches(290) == 3


def test_tree_returns_contiguous_views_of_one_buffer_per_dtype():
    """Same keys, shapes and dtypes; each leaf a contiguous view starting
    16 bytes aligned in its dtype's one flat buffer, no two overlapping;
    the inputs are left as they were."""
    shapes = {"a": ((3, 5), torch.float32), "b": ((77,), torch.bfloat16),
              "c": ((0,), torch.float32), "d": ((), torch.float32),
              "e": ((2, 64), torch.bfloat16), "f": ((129,), torch.float32)}
    gen = torch.Generator().manual_seed(0)
    g = {k: torch.randn(s, generator=gen).to(dt)
         for k, (s, dt) in shapes.items()}
    l = {k: torch.randn(s, generator=gen).to(dt)
         for k, (s, dt) in shapes.items()}
    before = {k: (v.clone(), l[k].clone()) for k, v in g.items()}
    out = ops.weighted_agg_tree(g, l, 0.5, 0.8719)
    assert list(out) == list(shapes)
    for dt in (torch.float32, torch.bfloat16):
        keys = [k for k in shapes if shapes[k][1] == dt]
        base = out[keys[0]].untyped_storage().data_ptr()
        spans = []
        for k in keys:
            v = out[k]
            assert v.shape == shapes[k][0] and v.dtype == dt
            assert v.is_contiguous()
            assert v.untyped_storage().data_ptr() == base
            assert (v.storage_offset() * v.element_size()) % 16 == 0
            spans.append((v.storage_offset(), v.storage_offset() + v.numel()))
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for k, (gb, lb) in before.items():
        assert torch.equal(g[k], gb) and torch.equal(l[k], lb)
        assert torch.equal(out[k], ref.weighted_agg(gb, lb, 0.5, 0.8719))


@pytest.mark.parametrize("case", ["dtype", "device", "keys"])
def test_tree_rejects_mixed_inputs(case):
    """A leaf whose g and l differ in dtype, leaves on two devices, and
    dicts with different keys raise before any work."""
    g = {"a": torch.zeros(4), "b": torch.zeros(4)}
    l = {"a": torch.zeros(4), "b": torch.zeros(4)}
    if case == "dtype":
        l["b"] = l["b"].to(torch.bfloat16)
    elif case == "device":
        g["b"] = torch.zeros(4, device="meta")
        l["b"] = torch.zeros(4, device="meta")
    else:
        del l["b"]
    kernels.reset_launches()
    with pytest.raises(ValueError):
        ops.weighted_agg_tree(g, l, 0.5, 1.0)
    assert ops.KERNEL.launches == 0


@pytest.mark.parametrize("case", ["shape", "dtype", "float64", "meta"])
def test_wrapper_rejects_bad_inputs(case):
    g = torch.zeros(256)
    bad = {
        "shape": (g, torch.zeros(255)),
        "dtype": (g, torch.zeros(256, dtype=torch.bfloat16)),
        "float64": (g.double(), g.double()),
        "meta": (torch.zeros(256, device="meta"),
                 torch.zeros(256, device="meta")),
    }[case]
    kernels.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        ops.weighted_agg(*bad, 0.5, 1.0)
    assert ops.KERNEL.launches == 0


def test_build_failure_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    """A failing nvcc raises with its stderr, and a missing one raises
    naming where it looked: nothing falls back to the plain version."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such arch' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match="(?s)exit 3.*no such arch"):
        build.build(["weighted_agg.cu"])
    assert not list((tmp_path / "_build").glob("*.so"))
    monkeypatch.undo()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "none" / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_library_path_keyed_by_source_and_flags(monkeypatch):
    a = build.library_path("weighted_agg.cu")
    assert a == build.library_path("weighted_agg.cu")
    assert a.parent == build.BUILD_DIR and a.name.startswith("weighted_agg-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("weighted_agg.cu") != a
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.parametrize("P", [128, 1152, 128 * 300, 128 * 1031, 422016,
                               128 * 132 * 512 + 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ring_geometry_partitions_the_buffer(P, dtype):
    """K1's balanced grid: a multiple of the 132 SMs, each block one run of
    16-byte packs in block order, the runs differing by at most one pack
    and together covering [0, P) once, including pack counts the block
    count does not divide and fewer packs than blocks."""
    (geo,) = ops.ring_geometry(P, 3, dtype)
    blocks = geo.grid[0]
    elems = 16 // dtype.itemsize
    packs = P // elems
    assert blocks % ops.SMS == 0
    assert packs <= blocks * ops.THREADS * ops.RING_PACKS
    assert blocks == ops.SMS or packs > (blocks - ops.SMS) * ops.THREADS \
        * ops.RING_PACKS
    runs = [geo.outputs["out"].ranges((b,)) for b in range(blocks)]
    at = 0
    sizes = set()
    for (lo, hi), in runs:
        assert lo == at and lo % elems == 0 and hi >= lo
        sizes.add((hi - lo) // elems)
        at = hi
    assert at == P and max(sizes) - min(sizes) <= 1
    assert ops.ring_geometry(P, 0, dtype) == []
