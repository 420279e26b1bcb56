"""The slice's aggregation rules against ``repro``: end to end, the afl,
fedasync and fedbuff baselines and mafl's literal reading of Eqs.
(10)-(11) on quick-k5 for a few rounds from the same init (tolerances
stated in ``_torch_world.py``); and each rule alone on the same params."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.aggregation as jagg
import repro_torch.core.aggregation as tagg
from _torch_world import assert_conforms, jax_init, run_both
from repro_torch.models.cnn import CNN_SHAPES
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def init():
    return jax_init()


@pytest.mark.parametrize("scheme, interpretation, engine", [
    ("afl", "mixing", "serial"),
    ("fedasync", "mixing", "batched"),
    ("fedbuff", "mixing", "serial"),
    ("mafl", "literal", "serial"),
])
def test_scheme_matches_repro(init, scheme, interpretation, engine):
    jres, tres = run_both("quick-k5", init, rounds=4, engine=engine,
                          scheme=scheme, interpretation=interpretation)
    assert len(tres.rounds) == 4 and tres.scheme == scheme
    assert_conforms(jres, tres)


def _trees(n, seed=0):
    """``n`` CNN-shaped param dicts as (jax, torch) pairs from numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = {k: rng.normal(size=s).astype(np.float32)
             for k, s in CNN_SHAPES.items()}
        out.append(({k: jnp.asarray(v) for k, v in t.items()},
                    {k: torch.from_numpy(v) for k, v in t.items()}))
    return out


@pytest.mark.parametrize("rule", [
    "mafl-mixing", "mafl-mixing-kernel", "mafl-literal",
    "mafl-literal-kernel", "afl", "fedasync", "mix", "literal", "fedavg",
    "fedbuff"])
def test_aggregation_rule_matches_repro(rule):
    """Each rule on the same params and scalars.  The eager rules and the
    port round identically; repro's jitted ``*_donated`` forms and the
    interpreted Pallas kernel may contract a multiply-add into an FMA, so
    the comparison allows a few f32 ulps (rtol 1e-6, atol 1e-6 on values
    of order 1)."""
    (jg, tg), (jl, tl), (jl2, tl2), (jl3, tl3) = _trees(4, seed=len(rule))
    beta, weight, stale = 0.5, 0.8719, 3.25
    kernel = rule.endswith("-kernel")
    interp = "literal" if "literal" in rule else "mixing"
    if rule.startswith("mafl"):
        want = jagg.mafl_update(jg, jl, beta, weight, use_kernel=kernel,
                                interpretation=interp)
        got = tagg.mafl_update(tg, tl, beta, weight, use_kernel=kernel,
                               interpretation=interp)
    elif rule == "afl":
        want, got = (jagg.afl_update(jg, jl, beta),
                     tagg.afl_update(tg, tl, beta))
    elif rule == "fedasync":
        want = jagg.fedasync_update(jg, jl, 0.5, stale)
        got = tagg.fedasync_update(tg, tl, 0.5, stale)
    elif rule == "mix":
        want = jagg.mix_update_donated(jg, dict(jl), 0.0734125)
        got = tagg.mix_update(tg, tl, 0.0734125)
    elif rule == "literal":
        want = jagg.literal_update_donated(jg, dict(jl), beta, weight)
        got = tagg.literal_update(tg, tl, beta, weight)
    elif rule == "fedavg":
        want = jagg.fedavg_update(jg, [jl, jl2, jl3], [120, 45, 301])
        got = tagg.fedavg_update(tg, [tl, tl2, tl3], [120, 45, 301])
    else:
        jbuf, tbuf = jagg.FedBuffAggregator(3), tagg.FedBuffAggregator(3)
        for a, b in [(jl, tl), (jl2, tl2)]:
            assert jbuf.add(jg, a)[1] is tbuf.add(tg, b)[1] is False
        want, _ = jbuf.add(jg, jl3)
        got, flushed = tbuf.add(tg, tl3)
        assert flushed
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
