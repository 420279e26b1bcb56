"""The dense-attention architectures' configs, parameter counts, frontends,
cache shapes and the raises of the port against ``repro``.

Every config's fields equal ``repro``'s (the full config, ``reduced()`` and
mistral-nemo-12b's ``sliding_window_variant()``); the full configs'
parameter counts (the port's from the meta device) equal ``repro``'s
analytic counts; the frontend stubs draw what ``repro``'s do in shape,
dtype and scale; caches have ``repro``'s shapes; ``BatchedServer`` refuses
ring caches and vision configs at construction, as ``repro``'s would fail
mid-run."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_archs import CASES, arch_pair, cache_leaves
from _torch_threads import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import mistral_nemo_12b as jmistral
from repro.models import frontends as jfrontends
from repro.models import transformer as jT
from repro_torch.configs import get_config, list_archs
from repro_torch.configs import mistral_nemo_12b as tmistral
from repro_torch.models import frontends as tfrontends
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedServer

pytestmark = pytest.mark.usefixtures("one_thread")

PARAM_COUNTS = {"mistral-nemo-12b": 12_247_782_400,
                "qwen1.5-4b": 3_950_369_280,
                "internvl2-2b": 1_889_146_880,
                "musicgen-large": 3_229_812_736,
                "llama3-405b": 405_853_388_800}
NEW_ARCHS = tuple(PARAM_COUNTS)


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_registry_lists_the_dense_archs():
    """The dense archs, smollm-360m, (since the MoE + MLA slice)
    deepseek-v2-lite-16b and llama4-scout-17b-a16e, and (since the SSM
    slice) rwkv6-1.6b and jamba-v0.1-52b: every arch ``repro``
    registers."""
    moe = {"deepseek-v2-lite-16b", "llama4-scout-17b-a16e"}
    ssm = {"rwkv6-1.6b", "jamba-v0.1-52b"}
    assert set(NEW_ARCHS) | {"smollm-360m"} | moe | ssm == set(list_archs())
    assert set(list_archs()) == set(jlist_archs())


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("form", ["full", "reduced"])
def test_config_fields_equal_repro(arch, form):
    j, t = jget_config(arch), get_config(arch)
    if form == "reduced":
        j, t = j.reduced(), t.reduced()
    assert _fields(t) == _fields(j)
    assert [dataclasses.astuple(s) for s in t.sublayers()] == \
        [dataclasses.astuple(s) for s in j.sublayers()]
    assert t.supports_long_context == j.supports_long_context


@pytest.mark.parametrize("window", [4096, 64])
def test_sliding_window_variant_equals_repro(window):
    j = jmistral.sliding_window_variant(window)
    t = tmistral.sliding_window_variant(window)
    assert _fields(t) == _fields(j)
    assert _fields(t.reduced()) == _fields(j.reduced())
    assert t.sliding_window == window and t.supports_long_context


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_param_count_equals_repro(arch):
    """From the meta device on the port's side, ``repro``'s analytic
    ``param_count`` (shapes only) on its own."""
    assert tT.param_count(get_config(arch)) == PARAM_COUNTS[arch]
    assert jT.param_count(jget_config(arch)) == PARAM_COUNTS[arch]


@pytest.mark.parametrize("case", CASES)
def test_reduced_param_count_and_leaves_equal_repro(case):
    jcfg, jparams, tcfg, model = arch_pair(case)
    assert tT.param_count(tcfg) == jT.param_count(jcfg)
    names = [name for name, _ in model.named_parameters()]
    assert any(n.endswith("mixer.bq") for n in names) == tcfg.qkv_bias
    assert ("lm_head.w" in names) == (not tcfg.tie_embeddings)


@pytest.mark.parametrize("case", CASES)
def test_cache_shapes_equal_repro(case):
    """``init_cache`` and a grown prefill cache have ``repro``'s shapes:
    rings of min(width, max_seq) slots, full caches of max_seq."""
    jcfg, _, tcfg, model = arch_pair(case)
    P = 8 + (tcfg.n_frontend_tokens if tcfg.frontend == "vision" else 0)
    for max_seq in (16, 100):
        want = jax.eval_shape(lambda: jT.init_cache(jcfg, 2, max_seq))
        fresh = tT.init_cache(tcfg, 2, max_seq, device="cpu")
        assert {k: tuple(v.shape) for k, v in cache_leaves(fresh).items()} \
            == {k: tuple(v.shape) for k, v in cache_leaves(want).items()}
    fe = None
    if tcfg.frontend == "vision":
        fe = torch.zeros(2, tcfg.n_frontend_tokens, tcfg.d_model)
    _, cache = tT.prefill(tcfg, model, torch.zeros(2, 8, dtype=torch.int64),
                          fe)
    grown = tT.grow_cache(tcfg, cache, 2, P + 100)
    want = jax.eval_shape(lambda: jT.init_cache(jcfg, 2, P + 100))
    assert {k: tuple(v.shape) for k, v in cache_leaves(grown).items()} == \
        {k: tuple(v.shape) for k, v in cache_leaves(want).items()}


@pytest.mark.parametrize("case", ["swa", "chunk"])
def test_grow_cache_raises_where_repro_pad_fails(case):
    """A short prompt's ring is padded to the full window; a ``max_seq``
    under the window cannot hold it (``repro``'s pad fails there)."""
    _, _, tcfg, model = arch_pair(case)
    _, cache = tT.prefill(tcfg, model, torch.zeros(1, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="does not fit"):
        tT.grow_cache(tcfg, cache, 1, 32)
    grown = tT.grow_cache(tcfg, cache, 1, 64)
    for k, v in cache_leaves(grown).items():
        if k.startswith("sub0."):               # the ring passes through
            assert v is cache_leaves(cache)[k]


@pytest.mark.parametrize("case", ["swa", "chunk", "internvl2"])
def test_batched_server_refuses_at_construction(case):
    _, _, tcfg, model = arch_pair(case)
    match = "patch embeddings" if case == "internvl2" else "ring caches"
    with pytest.raises(ValueError, match=match):
        BatchedServer(tcfg, model, n_slots=2, max_seq=32)


def test_vision_config_without_embeddings_raises():
    _, _, tcfg, model = arch_pair("internvl2")
    tokens = torch.zeros(1, 4, dtype=torch.int64)
    for fn in (tT.prefill, tT.forward, tT.forward_hidden):
        with pytest.raises(ValueError, match="frontend_embeds"):
            fn(tcfg, model, tokens)


def test_frontend_stubs_match_repro_in_shape_dtype_and_scale():
    vcfg = get_config("internvl2-2b").reduced()
    acfg = get_config("musicgen-large").reduced()
    g = torch.Generator().manual_seed(0)
    emb = tfrontends.frontend_for(vcfg)(g, 3)
    jemb = jfrontends.frontend_for(jget_config("internvl2-2b").reduced())(
        jax.random.PRNGKey(0), 3)
    assert tuple(emb.shape) == jemb.shape == (3, 16, vcfg.d_model)
    assert emb.dtype == torch.float32 and jemb.dtype == np.float32
    assert abs(float(emb.std()) - 0.02) < 2e-3
    codes = tfrontends.frontend_for(acfg)(g, 2, 50)
    assert codes.dtype == torch.int32 and tuple(codes.shape) == (2, 50)
    assert 0 <= int(codes.min()) and int(codes.max()) < acfg.vocab_size
    assert tfrontends.frontend_for(get_config("smollm-360m")) is None
    with pytest.raises(ValueError, match="no vision frontend"):
        tfrontends.VisionFrontendStub(acfg)
