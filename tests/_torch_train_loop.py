"""Shared by ``test_torch_train_loop.py`` and
``test_torch_train_loop_kernel.py``: ``launch/train.py``'s MAFL loop in the
port against ``repro``'s, from ``repro``'s init of smollm-360m reduced: 3
rounds of 2 local SGD steps.

The vehicle sequence (host f64 timeline) must be identical, and so must
every minibatch (the same numpy draws).  Every local loss within rtol 1e-5
and the final global model within atol 2e-6 / rtol 1e-5: both sides run f32
on the CPU; one SGD step differs by ~1e-7 (``test_torch_train.py``), and six
steps and three merges carry that forward."""
from __future__ import annotations

import jax
import numpy as np

from _torch_world import transformer_pair
from repro.core.events import EventQueue as JEventQueue
from repro.launch import train as jtrain
from repro_torch.convert import transformer_params_to_numpy
from repro_torch.launch import train as ttrain

LOSS_TOL = dict(atol=0, rtol=1e-5)
PARAM_TOL = dict(atol=2e-6, rtol=1e-5)
ROUNDS, L_ITERS = 3, 2


def _record_repro(monkeypatch):
    """Patch ``repro``'s training loop to record the popped vehicles and
    every loss its ``value_and_grad`` returns, with the batch's row
    count."""
    vehicles, losses = [], []

    class Recording(JEventQueue):
        def pop(self):
            ev = super().pop()
            vehicles.append(ev.vehicle)
            return ev

    real = jtrain.lm_loss_and_grad

    def recording_vg(cfg):
        vg = real(cfg)

        def call(params, tokens):
            loss, grads = vg(params, tokens)
            losses.append((tokens.shape[0], float(loss)))
            return loss, grads
        return call

    monkeypatch.setattr(jtrain, "EventQueue", Recording)
    monkeypatch.setattr(jtrain, "lm_loss_and_grad", recording_vg)
    return vehicles, losses


def _record_port(monkeypatch):
    losses = []
    real = ttrain.lm_loss_and_grad

    def recording_vg(cfg, model):
        vg = real(cfg, model)

        def call(params, tokens):
            loss, grads = vg(params, tokens)
            losses.append((tokens.shape[0], float(loss)))
            return loss, grads
        return call

    monkeypatch.setattr(ttrain, "lm_loss_and_grad", recording_vg)
    return losses


def assert_training_loop_matches_repro(monkeypatch, scheme, use_kernel):
    argv = ["--reduced", "--rounds", str(ROUNDS), "--l-iters", str(L_ITERS),
            "--scheme", scheme] + (["--use-kernel"] if use_kernel else [])
    vehicles, jlosses = _record_repro(monkeypatch)
    jfinal = jtrain.main(argv)
    tlosses = _record_port(monkeypatch)
    _, _, tcfg, model = transformer_pair()
    args = ttrain.build_parser().parse_args(argv + ["--device", "cpu"])
    lines = []
    run = ttrain.run_training(tcfg, model, args, log=lines.append)

    assert run.vehicles == vehicles and len(vehicles) == ROUNDS
    # the local steps (batch of 8); repro also differentiates its held-out
    # loss (32 rows), which the port computes without a gradient
    jlocal = [v for n, v in jlosses if n == args.batch]
    assert [n for n, _ in tlosses] == [args.batch] * ROUNDS * L_ITERS
    np.testing.assert_allclose([v for _, v in tlosses], jlocal, **LOSS_TOL)
    np.testing.assert_allclose([float(v) for v in run.local_losses],
                               jlocal[L_ITERS - 1::L_ITERS], **LOSS_TOL)
    jheld = [v for n, v in jlosses if n == 32]
    assert [r for r, _ in run.heldout] == [ROUNDS] and len(jheld) == 1
    np.testing.assert_allclose([run.heldout[0][1]], jheld, **LOSS_TOL)
    assert lines[-1].startswith(f"round {ROUNDS:3d} vehicle {vehicles[-1]} ")

    got = transformer_params_to_numpy(run.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jfinal):
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), err_msg=str(path),
                                   **PARAM_TOL)
