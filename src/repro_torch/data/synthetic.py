"""Synthetic datasets.

The container is offline, so MNIST itself is unavailable; ``synth_mnist``
generates a deterministic drop-in: 10 classes of 28x28 grayscale images built
from smooth random class prototypes + per-sample jitter/shift/noise.  A small
CNN separates it at >95% accuracy within a few hundred SGD steps, matching the
paper's use of MNIST as an easy witness task.  The substitution is recorded in
DESIGN.md §6 and EXPERIMENTS.md — all paper claims we validate are *relative*
(MAFL vs AFL, curve shapes), not absolute MNIST numbers.
"""
from __future__ import annotations

import numpy as np


def _prototypes(rng: np.random.Generator, n_classes: int) -> np.ndarray:
    """Smooth class prototypes: low-frequency random fields, unit contrast."""
    protos = []
    for _ in range(n_classes):
        coarse = rng.normal(size=(7, 7))
        img = np.kron(coarse, np.ones((4, 4)))          # 28x28 blocky
        img = _blur(img)
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        protos.append(img)
    return np.stack(protos)


def _blur(img: np.ndarray) -> np.ndarray:
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        img = (np.take(img, np.arange(img.shape[ax]) - 1, axis=ax, mode="clip")
               * k[0]
               + img * k[1]
               + np.take(img, np.arange(img.shape[ax]) + 1, axis=ax,
                         mode="clip") * k[2])
    return img


def synth_mnist(n_train: int = 60000, n_test: int = 10000, seed: int = 0,
                n_classes: int = 10, noise: float = 0.25):
    """Returns (train_images, train_labels, test_images, test_labels);
    images are float32 [N, 28, 28, 1] in [0, 1]."""
    rng = np.random.default_rng(seed)
    protos = _prototypes(rng, n_classes)

    def make(n, rng):
        labels = rng.integers(0, n_classes, n)
        base = protos[labels]
        # per-sample random shift (+-2 px) and additive noise
        sx = rng.integers(-2, 3, n)
        sy = rng.integers(-2, 3, n)
        imgs = np.empty((n, 28, 28), np.float32)
        for shift_x in range(-2, 3):
            for shift_y in range(-2, 3):
                m = (sx == shift_x) & (sy == shift_y)
                if not m.any():
                    continue
                imgs[m] = np.roll(np.roll(base[m], shift_x, axis=1),
                                  shift_y, axis=2)
        imgs += rng.normal(scale=noise, size=imgs.shape).astype(np.float32)
        return np.clip(imgs, 0, 1)[..., None], labels.astype(np.int32)

    tr_i, tr_l = make(n_train, rng)
    te_i, te_l = make(n_test, np.random.default_rng(seed + 1))
    return tr_i, tr_l, te_i, te_l



def synth_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0):
    """Markov-ish synthetic token streams for transformer FL clients: each
    sequence follows a random sparse bigram table so there is real
    next-token signal to learn.  int32 [n_seqs, seq_len]; the same numpy
    draws, in the same order, as ``repro.data.synth_tokens``."""
    rng = np.random.default_rng(seed)
    n_next = min(8, vocab)
    table = rng.integers(0, vocab, size=(vocab, n_next))
    toks = np.empty((n_seqs, seq_len), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n_seqs)
    for t in range(1, seq_len):
        choice = rng.integers(0, n_next, n_seqs)
        explore = rng.random(n_seqs) < 0.1
        nxt = table[toks[:, t - 1], choice]
        toks[:, t] = np.where(explore, rng.integers(0, vocab, n_seqs), nxt)
    return toks
