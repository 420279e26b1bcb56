"""The port's checkpointing against ``repro``'s: each package loads the
other's npz and flat checkpoints bit for bit, ``tree_digest`` agrees on
equal trees, bf16 round-trips bitwise without ``ml_dtypes``, and retention
and the stale-``.tmp`` sweep behave as ``repro``'s do."""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_world import transformer_pair
from repro.checkpointing import checkpoint as jck
from repro.core.flat import ParamLayout as JParamLayout
from repro_torch.checkpointing import checkpoint as tck
from repro_torch.convert import (transformer_params_from_jax,
                                 transformer_params_to_numpy)
from repro_torch.core.flat import ParamLayout as TParamLayout
from repro_torch.models import transformer as tT
from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _mixed_trees(seed=0):
    """The same values as a torch tree and a numpy/ml_dtypes tree: f32 and
    bf16 leaves (bf16 with every bit pattern class: NaN, inf, -0.0,
    subnormals), a list and a scalar array."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 16, 257, dtype=np.uint16)
    bits[:4] = [0x7FC1, 0xFF80, 0x8000, 0x0001]
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    ttree = {"w": torch.from_numpy(f32),
             "ema": {"b16": torch.from_numpy(bits.view(np.int16)).view(
                 torch.bfloat16)},
             "hist": [torch.arange(4, dtype=torch.int32),
                      torch.tensor(2.5)]}
    jtree = {"w": f32.copy(),
             "ema": {"b16": bits.view(ml_dtypes.bfloat16)},
             "hist": [np.arange(4, dtype=np.int32), np.float32(2.5)]}
    return ttree, jtree


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x).view(np.uint8)


def test_tree_digest_equal_on_equal_trees():
    ttree, jtree = _mixed_trees()
    assert tck.tree_digest(ttree) == jck.tree_digest(jtree)
    assert tck.tree_digest(jtree) == jck.tree_digest(jtree)
    other = dict(ttree, w=ttree["w"] + 1)
    assert tck.tree_digest(other) != tck.tree_digest(ttree)


def test_port_checkpoint_loads_in_repro_and_back(tmp_path):
    ttree, jtree = _mixed_trees(1)
    path = tck.save_checkpoint(str(tmp_path), 7, ttree, meta={"k": 1})
    restored = jck.load_checkpoint(path, jtree)
    assert jck.tree_digest(restored) == jck.tree_digest(jtree)
    again = tck.load_checkpoint(path, ttree)
    assert tck.tree_digest(again) == tck.tree_digest(ttree)
    assert again["ema"]["b16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(again["ema"]["b16"]),
                                  _bits(ttree["ema"]["b16"]))
    with open(path + ".json") as f:
        assert json.load(f) == {"k": 1}


def test_merged_view_leaves_round_trip(tmp_path):
    """A merge through ``weighted_agg_tree`` returns views of one flat
    buffer per dtype; a checkpoint of those views holds each leaf's own
    elements only, loads back bit for bit in the port and in ``repro``,
    and digests as the same values in separate tensors do."""
    from repro_torch.kernels.weighted_agg import ops as agg_ops
    rng = np.random.default_rng(3)
    shapes = {"a": ((3, 5), np.float32), "b": ((77,), np.float32),
              "c": ((2, 3, 64), np.float32), "d": ((129,), np.float32)}
    g = {k: torch.from_numpy(rng.normal(size=s).astype(dt))
         for k, (s, dt) in shapes.items()}
    l = {k: torch.from_numpy(rng.normal(size=s).astype(dt))
         for k, (s, dt) in shapes.items()}
    g["e"] = torch.randn(33).to(torch.bfloat16)
    l["e"] = torch.randn(33).to(torch.bfloat16)
    merged = agg_ops.weighted_agg_tree(g, l, 0.5, 0.8719)
    assert merged["a"].untyped_storage().data_ptr() == \
        merged["d"].untyped_storage().data_ptr()
    copies = {k: v.clone() for k, v in merged.items()}
    assert tck.tree_digest(merged) == tck.tree_digest(copies)
    path = tck.save_checkpoint(str(tmp_path), 1, merged)
    with np.load(path) as data:
        assert {k: data[k].size for k in data.files} == {
            "a": 15, "b": 77, "c": 384, "d": 129, "e::bf16": 33}
    again = tck.load_checkpoint(path, copies)
    assert tck.tree_digest(again) == tck.tree_digest(copies)
    jtree = {k: np.asarray(v.float().numpy()) for k, v in copies.items()}
    jtree["e"] = np.zeros(33, ml_dtypes.bfloat16)
    restored = jck.load_checkpoint(path, jtree)
    for k in "abcd":
        np.testing.assert_array_equal(restored[k], copies[k].numpy())
    np.testing.assert_array_equal(_bits(np.asarray(restored["e"])),
                                  _bits(copies["e"]))


def test_repro_checkpoint_loads_in_the_port(tmp_path):
    ttree, jtree = _mixed_trees(2)
    path = jck.save_checkpoint(str(tmp_path), 3, jtree)
    assert tck.latest_checkpoint(str(tmp_path)) == path
    restored = tck.load_checkpoint(path, ttree)
    assert tck.tree_digest(restored) == jck.tree_digest(jtree)
    # a numpy template takes numpy leaves (bf16 stored, f32 wanted: cast)
    as_np = tck.load_checkpoint(path, {"w": np.zeros((3, 5), np.float32),
                                       "ema": {"b16": np.zeros(257,
                                                               np.float32)},
                                       "hist": [np.zeros(4, np.int32),
                                                np.float32(0)]})
    np.testing.assert_array_equal(
        as_np["ema"]["b16"], jtree["ema"]["b16"].astype(np.float32))


def test_transformer_checkpoints_cross_load(tmp_path):
    """A transformer in ``repro``'s nested, period-stacked layout: written
    by ``repro``, restored into the port's model; written by the port from
    a param dict, restored by ``repro``."""
    jcfg, jparams, tcfg, model = transformer_pair()
    jpath = jck.save_checkpoint(str(tmp_path / "j"), 1, jparams)
    template = transformer_params_to_numpy(model)
    tree = tck.load_checkpoint(jpath, template)
    back = transformer_params_from_jax(tree, tcfg, "cpu")
    assert tck.tree_digest(transformer_params_to_numpy(back)) == \
        jck.tree_digest(jparams)
    params = {k: v * 2 for k, v in tT.param_dict(model).items()}
    tpath = tck.save_checkpoint(str(tmp_path / "t"), 1,
                                transformer_params_to_numpy(params))
    jrestored = jck.load_checkpoint(tpath, jparams)
    assert jck.tree_digest(jrestored) == jck.tree_digest(
        jax.tree_util.tree_map(lambda w: w * 2, jparams))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flat_checkpoints_cross_load(tmp_path, dtype):
    rng = np.random.default_rng(3)
    tree = {"conv": {"w": rng.normal(size=(3, 3, 2)).astype(np.float32),
                     "b": rng.normal(size=(5,)).astype(np.float32)},
            "fc": rng.normal(size=(200,)).astype(np.float32)}
    tlayout = TParamLayout.from_tree({k: (torch.from_numpy(v) if not
                                          isinstance(v, dict) else
                                          {a: torch.from_numpy(b)
                                           for a, b in v.items()})
                                      for k, v in tree.items()})
    jlayout = JParamLayout.from_tree(tree)
    jflat = jlayout.pack(jax.tree_util.tree_map(jnp.asarray, tree))
    if dtype == "bf16":
        jflat = jflat.astype(jnp.bfloat16)
    jpath = jck.save_flat_checkpoint(str(tmp_path / "j"), 0,
                                     np.asarray(jflat), jlayout)
    tflat, layout = tck.load_flat_checkpoint(jpath)
    assert layout.signature() == tlayout.signature()
    np.testing.assert_array_equal(_bits(tflat), _bits(np.asarray(jflat)))
    tpath = tck.save_flat_checkpoint(str(tmp_path / "t"), 0, tflat, layout)
    jback, jl = jck.load_flat_checkpoint(tpath)
    assert jl.to_json() == jlayout.to_json()
    np.testing.assert_array_equal(_bits(jback), _bits(np.asarray(jflat)))
    unpacked = layout.unpack(tflat)
    np.testing.assert_array_equal(unpacked["fc"].float().numpy(),
                                  np.asarray(jflat[jlayout.offsets[2]:
                                                   jlayout.offsets[2] + 200]
                                             .astype(jnp.float32)))


def test_retention_latest_and_stale_tmp_sweep(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(4.0)}
    # a killed writer's leftovers: never visible, swept on the next save
    for stale in ("ckpt_00000009.npz.tmp", "ckpt_00000009.npz.json.tmp"):
        (tmp_path / stale).write_bytes(b"partial")
    assert tck.latest_checkpoint(d) is None
    for step in range(5):
        tck.save_checkpoint(d, step, tree, keep=2, meta={"step": step})
    names = sorted(os.listdir(d))
    assert names == ["ckpt_00000003.npz", "ckpt_00000003.npz.json",
                     "ckpt_00000004.npz", "ckpt_00000004.npz.json"]
    assert tck.latest_checkpoint(d) == os.path.join(d, "ckpt_00000004.npz")
    assert jck.latest_checkpoint(d) == tck.latest_checkpoint(d)
    assert tck.latest_checkpoint(str(tmp_path / "missing")) is None


def test_failed_write_leaves_no_visible_checkpoint(tmp_path, monkeypatch):
    d = str(tmp_path)
    tck.save_checkpoint(d, 1, {"w": torch.ones(3)})

    def boom(f, **kw):
        f.write(b"half")
        raise OSError("disk full")
    monkeypatch.setattr(tck.np, "savez", boom)
    with pytest.raises(OSError):
        tck.save_checkpoint(d, 2, {"w": torch.ones(3)}, meta={"step": 2})
    assert tck.latest_checkpoint(d) == os.path.join(d, "ckpt_00000001.npz")
    monkeypatch.undo()
    tck.save_checkpoint(d, 3, {"w": torch.ones(3)})
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    with pytest.raises(ValueError, match="stored"):
        tck.load_checkpoint(tck.latest_checkpoint(d), {"w": torch.ones(4)})
