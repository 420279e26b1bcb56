"""Shared by the dense-arch tests (``test_torch_archs*.py``): the reduced
configs of the five dense-attention architectures in both packages, one
weight set per config (``repro``'s ``T.init_params`` draws, with the QKV
biases set to non-zero numpy draws so that they count), ``repro``'s jitted
prefill and decode per config, and the comparisons.

Cases: ``qwen`` (qwen1.5-4b: QKV biases, MHA), ``musicgen`` (musicgen-large:
audio codes as tokens, hd 64, MHA), ``internvl2`` (internvl2-2b: 16 patch
embeddings before the text, G 2), ``swa`` (mistral-nemo-12b's
``sliding_window_variant()``: window 64, G 4) and ``chunk`` (mistral-nemo-12b
with ``attn_chunk`` 64 and ``global_attn_every`` 2: periods of ``[chunk,
global]`` sublayers, two periods).

Tolerances are ``test_torch_transformer.py``'s: both sides f32 on the CPU,
summing the matrix products in different orders, a few ulps per layer on
activations of size ~1-10: logits atol 1e-4 / rtol 1e-4, caches atol
1e-5."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import mistral_nemo_12b as jmistral
from repro.models import transformer as jT
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import mistral_nemo_12b as tmistral
from repro_torch.convert import transformer_params_from_jax

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=0)
CASES = ("qwen", "musicgen", "internvl2", "swa", "chunk")
ARCH = {"qwen": "qwen1.5-4b", "musicgen": "musicgen-large",
        "internvl2": "internvl2-2b"}
CHUNK_VARIANT = dict(attn_chunk=64, global_attn_every=2, scan_period=2,
                     n_layers=4)


def configs(case: str):
    """(repro's config, the port's config) of a case."""
    if case == "swa":
        return (jmistral.sliding_window_variant().reduced(),
                tmistral.sliding_window_variant().reduced())
    if case == "chunk":
        return tuple(get("mistral-nemo-12b").reduced().variant(
            **CHUNK_VARIANT) for get in (jget_config, tget_config))
    return jget_config(ARCH[case]).reduced(), tget_config(ARCH[case]).reduced()


@functools.lru_cache(maxsize=None)
def arch_pair(case: str):
    """``(jax cfg, jax params, port cfg, port model on the CPU)`` with the
    same weights; the biases (zero at init) are drawn here."""
    jcfg, tcfg = configs(case)
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for sub in tree["stack"].values():
        mixer = sub["mixer"]
        for name in ("bq", "bk", "bv"):
            if name in mixer:
                mixer[name] = (0.1 * rng.standard_normal(
                    mixer[name].shape)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, transformer_params_from_jax(tree, tcfg,
                                                            "cpu")


@functools.lru_cache(maxsize=None)
def jax_prefill(case: str):
    jcfg = configs(case)[0]
    return jax.jit(functools.partial(jT.prefill, jcfg))


@functools.lru_cache(maxsize=None)
def jax_decode(case: str):
    jcfg = configs(case)[0]
    return jax.jit(functools.partial(jT.decode_step, jcfg))


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def frontend(cfg, batch, seed):
    """A vision config's patch embeddings as numpy (None otherwise): the
    same array goes to both packages."""
    if cfg.frontend != "vision":
        return None
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def as_jax(x):
    return None if x is None else jnp.asarray(x)


def as_torch(x):
    return None if x is None else torch.from_numpy(x)


def cache_leaves(cache):
    return {f"{name}.{k}": v for name, sub in cache["stack"].items()
            for k, v in sub["mixer"].items()}


def assert_caches(tcache, jcache, where=""):
    t, j = cache_leaves(tcache), cache_leaves(jcache)
    assert set(t) == set(j)
    for k in j:
        assert tuple(t[k].shape) == tuple(j[k].shape), (where, k)
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   err_msg=f"{where} {k}", **CACHE_TOL)
