"""The checkpoint policies of the port's stack (``transformer._run_stack``)
on reduced deepseek-v2-lite-16b (a dense MLA prefix layer, then periods of
MLA + MoE): ``remat_policy="full"``, ``"dots"``, ``"dots_nb"``,
``remat_sublayer`` and ``no_remat`` give bitwise the same loss and
gradients on the CPU, within the f32 band of ``repro``'s gradients; and,
counted by a ``TorchDispatchMode`` over the backward with checkpoint early
stop off, each policy recomputes what its name says: ``dots`` no matrix
product, ``dots_nb`` the batch-dim products (``bmm``: attention scores,
MoE experts) and no ``mm``, ``full`` every product of the stack's forward.

Gradient band: both sides f32 on the CPU, atol 2e-5 / rtol 1e-4 (a few
ulps of gradients of size ~1e-3-1, summed in other orders), the band
``test_torch_train.py`` holds one SGD step at lr 0.05 to."""
from __future__ import annotations

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from _torch_threads import one_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import transformer as jT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import transformer_params_to_numpy
from repro_torch.kernels.cross_entropy.ops import lm_loss
from repro_torch.models import transformer as tT

pytestmark = pytest.mark.usefixtures("one_thread")

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
ARCH = "deepseek-v2-lite-16b"
POLICIES = {"full": {}, "dots": dict(remat_policy="dots"),
            "dots_nb": dict(remat_policy="dots_nb"),
            "remat_sublayer": dict(remat_sublayer=True),
            "no_remat": dict(no_remat=True)}
aten = torch.ops.aten
MM = (aten.mm.default, aten.addmm.default)
BMM = (aten.bmm.default, aten.baddbmm.default)


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))

    def products(self):
        return (sum(self.counts[op] for op in MM),
                sum(self.counts[op] for op in BMM))


@functools.lru_cache(maxsize=None)
def pair():
    """(repro cfg, the weights as numpy, port cfg, port model, tokens):
    the port's seeded init, handed to ``repro`` as numpy."""
    jcfg, tcfg = jget_config(ARCH).reduced(), tget_config(ARCH).reduced()
    model = tT.init_params(tcfg, torch.Generator().manual_seed(2),
                           device="cpu")
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 33)).astype(np.int32)
    return jcfg, transformer_params_to_numpy(model), tcfg, model, toks


@functools.lru_cache(maxsize=None)
def port_grads(policy):
    """(loss, grads, the backward's (mm, bmm) counts) under ``policy``."""
    _, _, tcfg, model, toks = pair()
    cfg = tcfg.variant(**POLICIES[policy])
    params = {k: v.detach().requires_grad_()
              for k, v in tT.param_dict(model).items()}
    t = torch.from_numpy(toks)
    with set_checkpoint_early_stop(False):
        logits, aux = tT.apply_params(cfg, model, params, t[:, :-1])
        loss = lm_loss(logits, t[:, 1:]) + aux
    with CountOps() as mode:
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), mode.products()


@pytest.mark.parametrize("policy", [p for p in POLICIES if p != "full"])
def test_gradients_are_bitwise_across_policies(policy):
    loss, grads, _ = port_grads(policy)
    want_loss, want, _ = port_grads("full")
    assert torch.equal(loss, want_loss)
    assert set(grads) == set(want)
    for k in want:
        assert torch.equal(grads[k], want[k]), (policy, k)


def test_gradients_match_repro():
    jcfg, tree, tcfg, model, toks = pair()

    def loss_fn(p, t):
        logits, aux = jT.forward(jcfg, p, t[:, :-1])
        lse = jax.nn.logsumexp(logits.astype(jnp.float32), -1)
        picked = jnp.take_along_axis(logits.astype(jnp.float32),
                                     t[:, 1:, None], -1)[..., 0]
        return jnp.mean(lse - picked) + aux

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jp, jnp.asarray(toks))
    loss, grads, _ = port_grads("full")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = transformer_params_to_numpy(grads)
    flat = jax.tree_util.tree_leaves_with_path(jgrads)
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(node, np.asarray(leaf), err_msg=str(path),
                                   **GRAD_TOL)
    assert np.abs(got["stack"]["sub0"]["mlp"]["router"]).max() > 0


def test_each_policy_recomputes_what_its_name_says():
    """(mm, bmm) in each backward against ``no_remat``'s (no recompute):
    ``dots`` equal, ``dots_nb`` every bmm of the stack's forward more,
    ``full`` every mm and bmm of it more."""
    _, _, tcfg, model, toks = pair()
    cfg = tcfg.variant(no_remat=True)
    S = toks.shape[1] - 1
    with CountOps() as fwd:
        tT._run_stack(cfg, model, torch.zeros(2, S, cfg.d_model),
                      torch.zeros(()), torch.arange(S, dtype=torch.int32))
    f_mm, f_bmm = fwd.products()
    assert f_mm > 0 and f_bmm > 0
    base_mm, base_bmm = port_grads("no_remat")[2]
    assert port_grads("dots")[2] == (base_mm, base_bmm)
    assert port_grads("dots_nb")[2] == (base_mm, base_bmm + f_bmm)
    assert port_grads("full")[2] == (base_mm + f_mm, base_bmm + f_bmm)
