"""The simulated world of the paper, written out plainly for the references.

Frozen copies of the host planning code a world needs: Table I's channel,
the single-RSU mobility (Eqs. 3-4), the Rayleigh AR(1) fading, the rate and
the delays (Eqs. 5-9), the time-ordered upload queue, the synthetic
MNIST-shaped data and its per-vehicle split (Section V-A).  Everything here
is numpy in float64, drawn from the same seeds in the same order as the
system under test draws them, so a world built here is the world the
benchmark hands the program.  Nothing here imports the program.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class Channel:
    """Table I in SI units; ``beta`` is the aggregation proportion (Eq. 11),
    ``zeta`` and ``gamma`` the delay-weight bases (Eqs. 7, 9)."""
    K: int = 10
    v: float = 20.0
    H: float = 10.0
    d_y: float = 10.0
    C_y: float = 1e5
    model_bits: float = 5000.0
    B: float = 1e5
    p_m: float = 0.1
    alpha: float = 2.0
    sigma2: float = 1e-14
    beta: float = 0.5
    zeta: float = 0.9
    gamma: float = 0.9
    fading_rho: float = 0.95
    coverage: float = 400.0

    def delta(self, i: int) -> float:
        """CPU cycles per second of vehicle ``i`` (1-based)."""
        return 1.5 * (i + 5) * 1e8

    def data_count(self, i: int) -> int:
        """D_i, the images vehicle ``i`` (1-based) carries."""
        return 2250 + 3750 * i

    def training_delay(self, i: int) -> float:
        """Eq. 8: C_l = D_i C_y / delta_i."""
        return self.data_count(i) * self.C_y / self.delta(i)

    def distance(self, k: int, t: float) -> float:
        """Eqs. 3-4 for vehicle ``k`` (0-based) at time ``t``: eastbound at
        ``v`` from an even spread over the coverage, wrapping at its edge,
        against the antenna at height ``H``."""
        span = 2 * self.coverage
        x0 = -self.coverage + span * (k / self.K)
        dx = ((x0 + self.v * t + self.coverage) % span) - self.coverage
        return float(np.linalg.norm(np.array([dx, self.d_y, 0.0])
                                    - np.array([0.0, 0.0, self.H])))

    def upload_delay(self, gain: float, distance: float) -> float:
        """Eqs. 5-6: |w| / (B log2(1 + p h d^-alpha / sigma^2))."""
        snr = self.p_m * gain * distance ** (-self.alpha) / self.sigma2
        rate = self.B * np.log2(1.0 + snr)
        return self.model_bits / max(rate, 1e-12)

    def weight(self, upload_delay: float, train_delay: float) -> float:
        """Eqs. 7 and 9: gamma^(C_u - 1) zeta^(C_l - 1)."""
        return (float(self.gamma ** (upload_delay - 1.0))
                * float(self.zeta ** (train_delay - 1.0)))

    def mix(self, upload_delay: float, train_delay: float) -> float:
        """The local model's share in the merge: clip((1 - beta) w, 0, 1)."""
        return float(np.clip((1.0 - self.beta)
                             * self.weight(upload_delay, train_delay),
                             0.0, 1.0))


def channel(config: dict, **changes) -> Channel:
    """The configuration's Table I with ``changes`` applied."""
    return replace(Channel(**config["channel"]), **changes)


class Fading:
    """Rayleigh power gains |g|^2, g an AR(1) complex Gaussian per vehicle
    with coherence ``rho``, drawn from ``default_rng(seed)``."""

    def __init__(self, ch: Channel, seed: int):
        self.ch = ch
        self.rng = np.random.default_rng(seed)
        self.g = (self.rng.normal(size=ch.K)
                  + 1j * self.rng.normal(size=ch.K)) / np.sqrt(2)

    def step(self) -> np.ndarray:
        rho = self.ch.fading_rho
        innov = (self.rng.normal(size=self.ch.K)
                 + 1j * self.rng.normal(size=self.ch.K)) / np.sqrt(2)
        self.g = rho * self.g + np.sqrt(1 - rho ** 2) * innov
        return np.abs(self.g) ** 2

    def block(self, n: int) -> np.ndarray:
        """``n`` steps at once, the same draws in the same order."""
        rho = self.ch.fading_rho
        innov = self.rng.normal(size=(n, 2, self.ch.K))
        innov = (innov[:, 0] + 1j * innov[:, 1]) / np.sqrt(2)
        out = np.empty((n, self.ch.K))
        g = self.g
        for t in range(n):
            g = rho * g + np.sqrt(1 - rho ** 2) * innov[t]
            out[t] = np.abs(g) ** 2
        self.g = g
        return out


class SlotGains:
    """Gains held per whole second of simulated time (slot ``int(t)``)."""

    def __init__(self, fading: Fading):
        self.fading = fading
        self.slots: dict[int, np.ndarray] = {}
        self.last = -1

    def at(self, t: float) -> np.ndarray:
        slot = int(t)
        if slot > self.last:
            block = self.fading.block(slot - self.last)
            for j in range(block.shape[0]):
                self.slots[self.last + 1 + j] = block[j]
            self.last = slot
        return self.slots[slot]


@dataclass(order=True)
class Upload:
    time: float
    seq: int
    vehicle: int = 0
    download_time: float = 0.0
    train_delay: float = 0.0
    upload_delay: float = 0.0
    snapshot: int = 0


class Uploads:
    """Pending uploads, popped in (time, push order)."""

    def __init__(self):
        self.heap: list[Upload] = []
        self.seq = 0

    def push(self, **kw) -> None:
        heapq.heappush(self.heap, Upload(seq=self.seq, **kw))
        self.seq += 1

    def pop(self) -> Upload:
        return heapq.heappop(self.heap)

    def __len__(self) -> int:
        return len(self.heap)


def synth_mnist(n_train: int, n_test: int, seed: int, noise: float):
    """MNIST-shaped images: 10 smooth random class prototypes, each sample
    shifted by up to 2 pixels and noised, clipped to [0, 1].  float32
    ``[N, 28, 28, 1]`` images and int32 labels, train then test."""
    rng = np.random.default_rng(seed)
    protos = []
    for _ in range(10):
        img = np.kron(rng.normal(size=(7, 7)), np.ones((4, 4)))
        k = np.array([0.25, 0.5, 0.25])
        for ax in (0, 1):
            idx = np.arange(img.shape[ax])
            img = (np.take(img, idx - 1, axis=ax, mode="clip") * k[0]
                   + img * k[1]
                   + np.take(img, idx + 1, axis=ax, mode="clip") * k[2])
        protos.append((img - img.min()) / (np.ptp(img) + 1e-9))
    protos = np.stack(protos)

    def make(n, rng):
        labels = rng.integers(0, 10, n)
        base = protos[labels]
        sx = rng.integers(-2, 3, n)
        sy = rng.integers(-2, 3, n)
        imgs = np.empty((n, 28, 28), np.float32)
        for a in range(-2, 3):
            for b in range(-2, 3):
                m = (sx == a) & (sy == b)
                if m.any():
                    imgs[m] = np.roll(np.roll(base[m], a, axis=1), b, axis=2)
        imgs += rng.normal(scale=noise, size=imgs.shape).astype(np.float32)
        return np.clip(imgs, 0, 1)[..., None], labels.astype(np.int32)

    tr = make(n_train, rng)
    te = make(n_test, np.random.default_rng(seed + 1))
    return tr[0], tr[1], te[0], te[1]


def split(images, labels, ch: Channel, seed: int, scale: float,
          cap: int | None):
    """Vehicle i's shard: ``max(int(D_i scale), 8)`` images, at most
    ``cap``, drawn without replacement; returns ``[(images, labels)]``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, ch.K + 1):
        d = max(int(ch.data_count(i) * scale), 8)
        if cap is not None:
            d = min(d, cap)
        sel = rng.choice(len(labels), size=min(d, len(labels)),
                         replace=False)
        out.append((images[sel], labels[sel]))
    return out


def minibatch(ch: Channel, world: dict) -> int:
    """The one minibatch size every vehicle of a world trains with: 128 or
    the smallest shard, if that is smaller."""
    sizes = [max(int(ch.data_count(i) * world["scale"]), 8)
             for i in range(1, ch.K + 1)]
    cap = world.get("max_per_vehicle")
    if cap is not None:
        sizes = [min(s, cap) for s in sizes]
    return min(128, min(sizes), world["n_train"])


def synth_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int):
    """Token rows that follow a random sparse bigram table (8 successors a
    token, one draw in ten uniform instead); int32 ``[n_seqs, seq_len]``."""
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
