"""Fingerprint of the numerics environment, the counterpart of
``repro.core.codegen``.

The golden fixtures pin bitwise sha256 digests of trained parameters.
Those bits depend on more than library versions: the kernels a device
picks (its convolution algorithms, its fused multiply-adds, how a
reduction is split) move the low bits, so the same program on the same
versions can give other bits on another card or host.  This module runs
a deterministic probe through the computations the simulations run (the
paper CNN's local SGD scan, solo and vmapped, and the staleness-weighted
mix, pow and log2 chain of Eqs. 5-11) and digests the f32 results
(``checkpointing.tree_digest``).  Two environments with the same digest
compute every pinned quantity alike; a fixture compares digests only
where it matches.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.device import resolve_device


def codegen_fingerprint(device=None) -> dict:
    """``{"backend": ..., "probe": <sha256>}`` for ``device`` (``None``:
    the card; ``backend`` its name, or ``"cpu"``).  Deterministic by
    construction: a seeded init, synthetic data, no datasets or clocks."""
    return dict(_fingerprint(str(resolve_device(device))))


@lru_cache(maxsize=None)
def _fingerprint(device: str) -> tuple:
    from repro_torch.checkpointing.checkpoint import tree_digest
    from repro_torch.core import client as client_mod
    from repro_torch.models.cnn import init_cnn

    dev = torch.device(device)
    params = init_cnn(torch.Generator().manual_seed(0), device=dev)
    l_iters, batch = 2, 8
    imgs = torch.from_numpy(
        np.linspace(-1.0, 1.0, l_iters * batch * 28 * 28, dtype=np.float32)
        .reshape(l_iters, batch, 28, 28, 1)).to(dev)
    labs = torch.from_numpy((np.arange(l_iters * batch) % 10)
                            .astype(np.int64).reshape(l_iters, batch)).to(dev)
    lr = 0.03

    # the two training contexts the engines use: a solo local scan and a
    # payload-stacked vmap
    solo, _ = client_mod._local_scan(params, imgs, labs, lr)
    stacked = {k: torch.stack([x, x * 0.5]) for k, x in params.items()}
    wave, _ = client_mod._local_scan_vmap(
        stacked, torch.stack([imgs, imgs]), torch.stack([labs, labs]), lr)

    # the Eq. 5-11 arithmetic: pow-weighted mix and a log2 Shannon rate
    def chain(a, b):
        w = torch.tensor(0.9, device=dev)
        weight = w ** (a - 1.0) * w ** (b - 1.0)
        alpha = torch.clamp((1.0 - 0.5) * weight, 0.0, 1.0)
        mix = (1.0 - alpha) * a + alpha * b
        rate = 1e5 * torch.log2(1.0 + a * b ** -2.0)
        return mix, rate

    x = torch.from_numpy(np.linspace(0.1, 3.0, 1024,
                                     dtype=np.float32)).to(dev)
    mix, rate = chain(x, x.flip(0))
    probe = {"solo": solo, "wave": wave, "mix": mix, "rate": rate}
    backend = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else dev.type)
    return (("backend", backend), ("probe", tree_digest(probe)))


def codegen_matches(recorded, device=None) -> bool:
    """True iff ``recorded`` (a fixture's ``codegen`` field) matches this
    environment.  Fixtures written before the fingerprint existed (no
    field) never match: their digests were pinned blind to it."""
    if not recorded:
        return False
    return recorded == codegen_fingerprint(device)
