"""One ``make_train_step`` of the dense-attention architectures in the port
against ``repro``'s on the same numpy weights, tokens and patch
embeddings: qwen1.5-4b (the QKV biases' gradients), internvl2-2b
(``patch_embeds``, the loss on the text positions only, also through the
vocab-chunked loss) and mistral-nemo-12b's sliding-window variant (S 80
past the window of 64); then the weights and an npz checkpoint with bias
leaves and an untied head, both ways.

Tolerances are ``test_torch_train.py``'s: losses rtol 1e-5, parameters
after one SGD step atol 1e-6 / rtol 1e-5 (lr times the gradient band, on
weights of size ~0.01-1)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_archs import arch_pair, frontend, tokens
from _torch_threads import one_thread  # noqa: F401
from repro.checkpointing import checkpoint as jck
from repro.launch import steps as jsteps
from repro_torch.checkpointing import checkpoint as tck
from repro_torch.convert import (transformer_params_from_jax,
                                 transformer_params_to_numpy)
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tT

pytestmark = pytest.mark.usefixtures("one_thread")

LOSS_TOL = dict(atol=0, rtol=1e-5)
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
LR = 0.05
# case: (the arch case, config overrides, tokens [B, S + 1])
TRAIN_CASES = {
    "qwen": ("qwen", dict(), (2, 33)),
    "internvl2": ("internvl2", dict(), (2, 33)),
    "internvl2-chunked-loss": ("internvl2", dict(loss_chunk=200), (2, 33)),
    "swa": ("swa", dict(), (2, 81)),
}


def _tree_close(tparams, jtree, where):
    got = transformer_params_to_numpy(tparams)
    flat = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf),
                                   err_msg=f"{where} {path}", **STEP_TOL)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step(name):
    case, overrides, shape = TRAIN_CASES[name]
    jcfg, jparams, tcfg, model = arch_pair(case)
    jcfg, tcfg = jcfg.variant(**overrides), tcfg.variant(**overrides)
    toks = tokens(tcfg, shape, 5)
    fe = frontend(tcfg, shape[0], 5)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if fe is not None:
        jbatch["patch_embeds"] = jnp.asarray(fe)
        tbatch["patch_embeds"] = torch.from_numpy(fe)
    jnew, jmetrics = jax.jit(jsteps.make_train_step(jcfg, lr=LR))(
        jparams, jbatch)
    tnew, tmetrics = tsteps.make_train_step(tcfg, lr=LR)(
        model, tT.param_dict(model), tbatch)
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(jmetrics["loss"]), **LOSS_TOL)
    _tree_close(tnew, jnew, name)
    if tcfg.qkv_bias:        # the biases moved: their gradients count
        moved = [k for k in tnew if k.endswith(("mixer.bq", "mixer.bk",
                                                "mixer.bv"))
                 and not torch.equal(tnew[k], tT.param_dict(model)[k])]
        assert len(moved) == 3 * tcfg.n_layers


@pytest.mark.parametrize("case", ["qwen", "musicgen"])
def test_weights_and_checkpoint_round_trip(case, tmp_path):
    """``repro``'s tree -> the port's model -> numpy equals the tree leaf
    for leaf (biases, untied head); a checkpoint either package writes
    loads bit for bit in the other."""
    jcfg, jparams, tcfg, model = arch_pair(case)
    back = transformer_params_to_numpy(model)
    assert tck.tree_digest(back) == jck.tree_digest(jparams)
    jpath = jck.save_checkpoint(str(tmp_path / "j"), 1, jparams)
    tree = tck.load_checkpoint(jpath, back)
    again = transformer_params_from_jax(tree, tcfg, "cpu")
    assert tck.tree_digest(transformer_params_to_numpy(again)) == \
        jck.tree_digest(jparams)
    doubled = {k: v * 2 for k, v in tT.param_dict(model).items()}
    tpath = tck.save_checkpoint(str(tmp_path / "t"), 1,
                                transformer_params_to_numpy(doubled))
    jrestored = jck.load_checkpoint(tpath, jparams)
    assert jck.tree_digest(jrestored) == jck.tree_digest(
        jax.tree_util.tree_map(lambda w: w * 2, jparams))
