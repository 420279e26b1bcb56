"""Table I of the paper, as a config object (SI units).

Note on units: the paper lists sigma^2 = 1e-11 mW = 1e-14 W and B = 1e5 Hz;
|w| = 5000 bits.  delta_i = 1.5*(i+5)*1e8 cycles/s (Section V-A, i is the
1-based vehicle index); D_i = 2250 + 3750*i images.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChannelParams:
    K: int = 10                    # vehicles
    v: float = 20.0                # m/s, eastbound
    H: float = 10.0                # RSU antenna height, m
    d_y: float = 10.0              # lateral offset, m
    C_y: float = 1e5               # CPU cycles per datum
    model_bits: float = 5000.0     # |w|
    B: float = 1e5                 # bandwidth, Hz
    p_m: float = 0.1               # transmit power, W
    alpha: float = 2.0             # path-loss exponent
    sigma2: float = 1e-14          # noise power, W (1e-11 mW)
    beta: float = 0.5              # aggregation proportion (Eq. 11)
    zeta: float = 0.9              # training-delay decay base (Eq. 9)
    gamma: float = 0.9             # uploading-delay decay base (Eq. 7)
    fading_rho: float = 0.95       # AR(1) coherence of the Rayleigh channel
    coverage: float = 400.0        # RSU coverage half-width, m (re-entry wrap)
    # platoon size (0/1 = Table-I heterogeneity per vehicle).  With
    # ``platoon = n``, vehicles travel in convoys of n that share the
    # platoon leader's compute and data volume, so every member's training
    # delay is identical and their uploads arrive in near-simultaneous
    # bursts — the bursty-arrival stress regime of the
    # ``platoon-burst-k500`` scenario (DESIGN.md §9).
    platoon: int = 0

    def _platoon_leader(self, i: int) -> int:
        if self.platoon > 1:
            return ((i - 1) // self.platoon) * self.platoon + 1
        return i

    def delta(self, i: int) -> float:
        """CPU frequency of vehicle i (1-based), cycles/s."""
        return 1.5 * (self._platoon_leader(i) + 5) * 1e8

    def data_count(self, i: int) -> int:
        """D_i: images carried by vehicle i (1-based)."""
        return 2250 + 3750 * self._platoon_leader(i)
