"""The transformer on DTensor parameters: one world of four gloo ranks
(``tests/_torch_shard.py``) over a (2, 2) ``("data", "model")`` mesh,
while this process runs the same steps unsharded, in the port and in
``repro``.

- Placements: each rank's local block of a spec'd array is the block
  JAX's row-major device order gives device ``(data, model)``: a dim over
  several axes is cut major to minor in the order the spec lists them.
- Training, reduced smollm-360m (GQA) and reduced deepseek-v2-lite-16b
  (MLA, MoE, a dense prefix layer): 2 SGD steps with
  ``shard_activations``, ``grad_specs``, FSDP forced on and 2
  microbatches.  The gathered parameters within 1e-5 of the port's
  unsharded step (the sharded products sum their halves in another order:
  about 1e-7 measured), and within ``_torch_train_loop.PARAM_TOL`` of
  ``repro``'s unsharded ``make_train_step`` from the same init; every
  parameter keeps its spec's placements.
- Serving at G 16 (llama3-405b reduced to H 32 over Kv 2): a sharded
  prefill of 8 tokens and 4 decode ticks on DTensor caches (K5 and K4 on
  each rank's rows and heads), every call's logits within 1e-5 of the
  unsharded run (a few 1e-6 measured: logits of size ~1 summed in halves).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import start
from _torch_shard import (ARCHS, BATCH, LR, PROMPT, SEQ, STEPS, g16_cfg,
                          init, serve, shard_body, tokens, train, train_cfg)
from _torch_threads import one_thread  # noqa: F401
from _torch_train_loop import PARAM_TOL
from repro.configs import get_config as jget
from repro.launch import steps as jsteps
from repro_torch.convert import transformer_params_to_numpy
from repro_torch.models import transformer as T

pytestmark = pytest.mark.usefixtures("one_thread")

SHARD_TOL = dict(rtol=0.0, atol=1e-5)
SPECS = ((("data", "model"), None), ("data", "model"), ("model", "data"),
         (None, "model"))


def _flat_jax(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat_jax(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _repro_train(arch, model, batch):
    jcfg = jget(arch).reduced().variant(microbatches=2)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    transformer_params_to_numpy(model))
    step = jax.jit(jsteps.make_train_step(jcfg, lr=LR))
    for _ in range(STEPS):
        params, _ = step(params, {"tokens": jnp.asarray(batch)})
    return _flat_jax(params)


@pytest.fixture(scope="module")
def runs(one_thread, tmp_path_factory):
    ranks = start(shard_body, 4, tmp_path_factory.mktemp("ranks"))
    try:
        port, jax_runs = {}, {}
        for arch in ARCHS:
            cfg = train_cfg(arch)
            batch = tokens(cfg, (BATCH, SEQ + 1), 1)
            port[arch] = {k: v.numpy() for k, v in train(
                cfg, init(cfg), {"tokens": torch.from_numpy(batch)}).items()}
            jax_runs[arch] = _repro_train(arch, init(cfg), batch)
        cfg = g16_cfg()
        port["g16"] = serve(cfg, init(cfg), torch.from_numpy(
            tokens(cfg, (BATCH, PROMPT), 2)))
    finally:
        out = ranks()
    return out, port, jax_runs


def _jax_block(grid, spec, coords, sizes):
    """The block of ``grid`` that JAX's ``NamedSharding`` gives the device
    at ``coords`` (mesh axes ``sizes``, row-major): each dim cut into
    ``prod(sizes of its axes)`` blocks, the block index mixed-radix over
    the axes in the spec's order."""
    names = list(sizes)
    idx = []
    for d, axes in enumerate(spec):
        if axes is None:
            idx.append(slice(None))
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        n, k = 1, 0
        for a in axes:
            k = k * sizes[a] + coords[names.index(a)]
            n *= sizes[a]
        step = grid.shape[d] // n
        idx.append(slice(k * step, (k + 1) * step))
    return grid[tuple(idx)]


def test_local_blocks_follow_jax_device_order(runs):
    out, _, _ = runs
    grid = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    sizes = {"data": 2, "model": 2}
    assert sorted(r["coords"] for r in out) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    for r in out:
        for spec in SPECS:
            np.testing.assert_array_equal(
                r["block", spec], _jax_block(grid, spec, r["coords"], sizes))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_matches_unsharded(runs, arch):
    out, port, jax_runs = runs
    for r in out:
        assert r[arch, "placements kept"]
        got = r[arch]
        assert set(got) == set(port[arch])
        for k, v in port[arch].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **SHARD_TOL)
    want = jax_runs[arch]
    for name, v in out[0][arch].items():
        parts = name.split(".")
        if parts[0] == "stack":
            ref = want[".".join(["stack", *parts[2:]])][int(parts[1])]
        else:
            ref = want[name]
        np.testing.assert_allclose(v, ref, err_msg=name, **PARAM_TOL)
        np.testing.assert_allclose(port[arch][name], ref, err_msg=name,
                                   **PARAM_TOL)


def test_sharded_g16_serving_matches_unsharded(runs):
    out, port, _ = runs
    assert g16_cfg().n_heads // g16_cfg().n_kv_heads == 16
    for r in out:
        assert len(r["g16"]) == len(port["g16"]) == 5
        for got, want in zip(r["g16"], port["g16"]):
            np.testing.assert_allclose(got, want, **SHARD_TOL)


def test_shard_activations_without_a_mesh_raises():
    """``repro``'s ``with_sharding_constraint`` raises outside a mesh; so
    does the port's reshard on plain tensors."""
    cfg = train_cfg("smollm-360m").variant(shard_activations=True)
    model = init(cfg)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        T.forward(cfg, model, torch.zeros((1, 4), dtype=torch.int64))
