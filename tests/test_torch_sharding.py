"""The port's sharding rules against ``repro``'s, for every registered arch
(and mistral-nemo-12b's sliding-window variant) at full size: the same
spec for every parameter (``stack.<i>.`` leaves against ``repro``'s
``stack`` leaf without its period axis), every cache leaf and the token
batch, and the same FSDP decision, on a 16 x 16 ``("data", "model")``
mesh, a 2 x 16 x 16 ``("pod", "data", "model")`` one and an indivisible 3
x 5.  Nothing is allocated on either side (``meta`` shapes and
``jax.eval_shape``); ``repro``'s meshes are ``AbstractMesh``es and the
port's ``{axis: size}`` dicts, so no process group is needed.  Equality is
exact: the specs are data."""
from __future__ import annotations

import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jsh
from repro.configs import get_config as jget, list_archs
from repro.configs.mistral_nemo_12b import \
    sliding_window_variant as jswa
from repro_torch.configs import get_config as tget
from repro_torch.configs.mistral_nemo_12b import \
    sliding_window_variant as tswa
from repro_torch.sharding import specs as S
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "3x5": ((3, 5), ("data", "model"))}
ARCHS = list_archs() + ["mistral-nemo-12b-swa"]


def _configs(arch):
    if arch == "mistral-nemo-12b-swa":
        return jswa(), tswa()
    return jget(arch), tget(arch)


def _spec(p):
    """A ``PartitionSpec`` as the port's plain tuple."""
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a for a in p)


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_repro(arch, mesh):
    shape, names = MESHES[mesh]
    jm, tm = AbstractMesh(shape, names), dict(zip(names, shape))
    jcfg, tcfg = _configs(arch)
    assert S.needs_fsdp(tcfg) == jsh.needs_fsdp(jcfg)
    want = {k: _spec(v) for k, v in _flat(jsh.param_specs(jcfg, jm)).items()}
    got = S.param_specs(tcfg, tm)
    seen = set()
    for name, spec in got.items():
        parts = name.split(".")
        if parts[0] == "stack":          # repro's leading period axis
            key, spec = ".".join(["stack", *parts[2:]]), (None, *spec)
        else:
            key = name
        assert spec == want[key], (name, spec, want[key])
        seen.add(key)
    assert seen == set(want)
    for batch, seq in ((128, 32768), (1, 524288), (3, 100)):
        jc = {k: _spec(v) for k, v in
              _flat(jsh.cache_specs(jcfg, jm, batch, seq)).items()}
        assert _flat(S.cache_specs(tcfg, tm, batch, seq)) == jc
    for batch in (1, 3, 32, 128, 256, 512):
        assert S.batch_spec(tm, batch) == _spec(jsh.batch_spec(jm, batch))


def test_fsdp_forced_and_placements():
    """``fsdp=True`` shards the d_model dims over the batch axes, and a
    spec turns into placements in mesh order: ``Shard(d)`` on each mesh
    dim whose axis names dim d; an axis order against the mesh's raises."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = tget("smollm-360m")
    tm = {"pod": 2, "data": 16, "model": 16}
    specs = S.param_specs(cfg, tm, fsdp=True)
    assert specs["stack.0.sub0.mlp.w_gate"] == (("pod", "data"), "model")
    assert specs["stack.0.sub0.mlp.w_down"] == ("model", ("pod", "data"))
    assert S.placements(tm, specs["stack.0.sub0.mlp.w_down"]) == (
        Shard(1), Shard(1), Shard(0))
    assert S.placements(tm, (None, "data")) == (Replicate(), Shard(1),
                                                Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        S.placements(tm, (("data", "pod"), None))
    tree = S.spec_tree_to_shardings(tm, {"a": [("model",), (None,)]})
    assert tree == {"a": [(Replicate(), Replicate(), Shard(0)),
                          (Replicate(),) * 3]}
    assert all(t.device.type == "meta" for t in
               torch.utils._pytree.tree_leaves(
                   S.T.init_cache(cfg, 2, 8, torch.bfloat16, "meta")))
