"""The paper's delay weights (Eqs. 7, 9).

beta_u = gamma ** (C_u - 1)     -- uploading-delay weight (mobility/channel)
beta_l = zeta  ** (C_l - 1)     -- training-delay weight (data/compute)

Host scalars in f64, as in ``repro.core.weights``.
"""
from __future__ import annotations

from repro_torch.channel.params import ChannelParams


def upload_weight(p: ChannelParams, upload_delay: float) -> float:
    """Eq. (7)."""
    return float(p.gamma ** (upload_delay - 1.0))


def training_weight(p: ChannelParams, train_delay: float) -> float:
    """Eq. (9)."""
    return float(p.zeta ** (train_delay - 1.0))


def combined_weight(p: ChannelParams, upload_delay: float,
                    train_delay: float) -> float:
    return upload_weight(p, upload_delay) * training_weight(p, train_delay)
