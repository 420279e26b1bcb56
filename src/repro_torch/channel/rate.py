"""Transmission rate and delays (Eqs. 5, 6, 8)."""
from __future__ import annotations

import numpy as np

from repro_torch.channel.params import ChannelParams


def shannon_rate(p: ChannelParams, gain: float, distance: float) -> float:
    """Eq. (5): r = B log2(1 + p_m h d^-alpha / sigma^2)."""
    snr = p.p_m * gain * distance ** (-p.alpha) / p.sigma2
    return p.B * np.log2(1.0 + snr)


def upload_delay(p: ChannelParams, rate: float) -> float:
    """Eq. (6): C_u = |w| / r."""
    return p.model_bits / max(rate, 1e-12)


def training_delay(p: ChannelParams, i: int) -> float:
    """Eq. (8): C_l = D_i C_y / delta_i   (i is 1-based)."""
    return p.data_count(i) * p.C_y / p.delta(i)
