"""Rayleigh fading with an AR(1) (autoregressive, Jakes-style) evolution per
vehicle, as in the paper's simulation setup ([18]-[20]): h^i(t) is the power
gain |g|^2 of a complex Gaussian g that decorrelates with coherence rho.
"""
from __future__ import annotations

import numpy as np

from repro_torch.channel.params import ChannelParams


class RayleighAR1:
    def __init__(self, params: ChannelParams, seed: int = 0):
        self.p = params
        self.rng = np.random.default_rng(seed)
        # complex CN(0,1) state per vehicle
        self.g = (self.rng.normal(size=params.K) +
                  1j * self.rng.normal(size=params.K)) / np.sqrt(2)

    def step(self) -> np.ndarray:
        """Advance one slot; returns power gains h^i(t) = |g|^2, shape [K]."""
        rho = self.p.fading_rho
        innov = (self.rng.normal(size=self.p.K) +
                 1j * self.rng.normal(size=self.p.K)) / np.sqrt(2)
        self.g = rho * self.g + np.sqrt(1 - rho ** 2) * innov
        return np.abs(self.g) ** 2

    def steps_block(self, n: int) -> np.ndarray:
        """Advance ``n`` slots; returns gains for each, shape [n, K].

        Bit-identical to ``n`` successive :meth:`step` calls (the (n, 2, K)
        normal draw consumes the generator's bitstream in exactly the
        real/imag per-slot order the scalar path uses) but with one RNG call
        instead of 2n — the fast path when a long-delay event forces the
        simulator to catch the channel up over many slots at once."""
        if n <= 0:
            return np.empty((0, self.p.K))
        rho = self.p.fading_rho
        innov = self.rng.normal(size=(n, 2, self.p.K))
        innov = (innov[:, 0] + 1j * innov[:, 1]) / np.sqrt(2)
        out = np.empty((n, self.p.K))
        scale = np.sqrt(1 - rho ** 2)
        g = self.g
        for t in range(n):
            g = rho * g + scale * innov[t]
            out[t] = np.abs(g) ** 2
        self.g = g
        return out

    def gain(self, i: int) -> float:
        return float(np.abs(self.g[i]) ** 2)


def slot_gain_table(params: ChannelParams, seed: int,
                    n_slots: int) -> np.ndarray:
    """Gains for slots ``0..n_slots-1`` as one ``[n_slots, K]`` table.

    The device-resident engine (DESIGN.md §9) replaces the incremental
    host-side :class:`SlotGainCache` with this precomputed table: the AR(1)
    recursion ``g_t = rho g_{t-1} + s i_t`` is a linear recurrence, so the
    whole table is produced by a *vectorized prefix scan* (log2(n) doubling
    passes of whole-array ops) instead of a per-slot Python loop.  The
    innovations are drawn in a single RNG call with exactly the bitstream
    layout of :meth:`RayleighAR1.steps_block`, so the table agrees with the
    sequential cache to f64 round-off (the summation order differs, not the
    random numbers) — pinned by ``tests/test_engine_conformance.py``."""
    K = params.K
    if n_slots <= 0:
        return np.empty((0, K))
    rng = np.random.default_rng(seed)
    g0 = (rng.normal(size=K) + 1j * rng.normal(size=K)) / np.sqrt(2)
    innov = rng.normal(size=(n_slots, 2, K))
    innov = (innov[:, 0] + 1j * innov[:, 1]) / np.sqrt(2)
    rho = params.fading_rho
    # per-slot affine map g -> A g + B; compose prefixes by doubling
    A = np.full(n_slots, rho)
    B = np.sqrt(1 - rho ** 2) * innov
    shift = 1
    while shift < n_slots:
        A_prev = np.concatenate([np.ones(shift), A[:-shift]])
        B_prev = np.vstack([np.zeros((shift, K), B.dtype), B[:-shift]])
        B = A[:, None] * B_prev + B
        A = A * A_prev
        shift *= 2
    g = A[:, None] * g0[None, :] + B
    return np.abs(g) ** 2


class SlotGainCache:
    """Windowed per-slot gain cache over a :class:`RayleighAR1` process.

    Gains are sampled once per discrete slot ``int(t)`` and kept only for
    the live window: the simulation prunes slots older than the earliest
    pending event every round (the time-ordered consumer can never revisit
    them), so memory is bounded by the event horizon rather than the
    simulation length (DESIGN.md §2)."""

    def __init__(self, fading: RayleighAR1):
        self._fading = fading
        self._cache: dict[int, np.ndarray] = {}
        self._last_slot = -1

    def at(self, t: float) -> np.ndarray:
        """Gains h^i(int(t)), advancing the AR(1) chain as needed."""
        slot = int(t)
        if slot > self._last_slot:
            block = self._fading.steps_block(slot - self._last_slot)
            for j in range(block.shape[0]):
                self._cache[self._last_slot + 1 + j] = block[j]
            self._last_slot = slot
        return self._cache[slot]

    def prune_below(self, t: float) -> None:
        """Drop every slot older than ``int(t)``."""
        keep = int(t)
        for s in [s for s in self._cache if s < keep]:
            del self._cache[s]

    @property
    def last_slot(self) -> int:
        """Highest slot the AR(1) chain has been advanced to (-1 if none).

        The jit-engine planner reads this after its dry run to size the
        precomputed :func:`slot_gain_table` (DESIGN.md §9)."""
        return self._last_slot

    def __len__(self) -> int:
        return len(self._cache)
