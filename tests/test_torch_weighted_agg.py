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
