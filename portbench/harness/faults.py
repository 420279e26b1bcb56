"""Faults planted in the program, to show that the comparison catches them.

Each fault breaks the timed path underneath a cell as a program could:

- ``step_unchanged``: a local SGD step returns the state it was given;
- ``half_batch``: a local step uses half of its minibatch, the loss the
  mean over the rest;
- ``input_altered``: one input of every minibatch is altered where the
  program stages it (a label of the CNN's images, a token of the LM's
  rows).

(The fourth fault of the contract, the exchange between chips left out,
has no place in a one-card cell.)  ``plant(entry, name, setattr)`` plants
fault ``name`` under a cell whose mix drives ``entry`` through
``setattr(module, attribute, value)``: pytest's ``monkeypatch.setattr`` in
the tests, plain ``setattr`` in ``limits.py``'s runs on the card.
"""
from __future__ import annotations

import importlib


def _cnn(name, setattr_):
    client = importlib.import_module("repro_torch.core.client")
    if name in ("step_unchanged", "half_batch"):
        orig = client.sgd_train_step

        def step(params, images, labels, lr):
            if name == "half_batch":
                n = images.shape[0] // 2
                return orig(params, images[:n], labels[:n], lr)
            _new, loss = orig(params, images, labels, lr)
            return dict(params), loss
        setattr_(client, "sgd_train_step", step)
    elif name == "input_altered":
        orig = client.Vehicle.sample_batches

        def sample_batches(self, l_iters):
            images, labels = orig(self, l_iters)
            labels = labels.copy()
            labels[0, 0] = (labels[0, 0] + 1) % 10
            return images, labels
        setattr_(client.Vehicle, "sample_batches", sample_batches)
    else:
        raise KeyError(name)


def _lm(name, setattr_):
    train = importlib.import_module("repro_torch.launch.train")
    if name in ("step_unchanged", "half_batch"):
        orig = train.lm_loss_and_grad

        def vg_of(cfg, model):
            vg = orig(cfg, model)

            def vg2(params, tokens):
                if name == "half_batch":
                    return vg(params, tokens[:len(tokens) // 2])
                loss, grads = vg(params, tokens)
                return loss, {k: g * 0 for k, g in grads.items()}
            return vg2
        setattr_(train, "lm_loss_and_grad", vg_of)
    elif name == "input_altered":
        orig = train._upload

        def upload(tokens, device):
            tokens = tokens.copy()
            tokens[0, 1] ^= 1           # another id below an even vocab
            return orig(tokens, device)
        setattr_(train, "_upload", upload)
    else:
        raise KeyError(name)


NAMES = ("step_unchanged", "half_batch", "input_altered")
KINDS = {"scenario": _cnn, "sweep": _cnn, "lm_train": _lm}


def plant(entry: str, name: str, setattr_=setattr) -> None:
    """Plant fault ``name`` under a cell whose mix drives ``entry``."""
    KINDS[entry](name, setattr_)
