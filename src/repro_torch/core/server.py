"""RSU-side state: the global model, round log, and aggregation dispatch."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.channel.params import ChannelParams
from repro_torch.core import aggregation
from repro_torch.core.weights import combined_weight
from repro_torch.device import resolve_device


@dataclass
class RoundRecord:
    round: int
    time: float
    vehicle: int               # 0-based
    upload_delay: float
    train_delay: float
    weight: float              # beta_u * beta_l (1.0 for plain AFL)
    loss: Optional[float] = None
    accuracy: Optional[float] = None
    # serving RSU the upload landed on (multi-RSU corridor engines only)
    rsu: Optional[int] = None


# fedasync's mixing coefficient (alpha = mix * (staleness+1)^-0.5)
DEFAULT_FEDASYNC_MIX = 0.5


class RSUServer:
    """Holds w_g and applies one aggregation per received upload
    (Algorithm 1 lines 6-7).  ``init_params`` is moved to ``device``."""

    def __init__(self, init_params, params: ChannelParams,
                 scheme: str = "mafl", use_kernel: bool = False,
                 fedbuff_size: int = 3,
                 fedasync_mix: float = DEFAULT_FEDASYNC_MIX,
                 interpretation: str = "mixing", device=None):
        self.device = resolve_device(device)
        self.global_params = {k: v.to(self.device)
                              for k, v in init_params.items()}
        self.p = params
        self.scheme = scheme
        self.use_kernel = use_kernel
        self.interpretation = interpretation
        self.rounds: list[RoundRecord] = []
        self._round = 0
        self._fedbuff = aggregation.FedBuffAggregator(fedbuff_size)
        self._fedasync_mix = fedasync_mix

    def receive(self, local_params, *, time: float, vehicle: int,
                upload_delay: float, train_delay: float,
                download_time: float, discard: bool = False) -> RoundRecord:
        """One upload -> one round r (Eq. 11 et al.).

        ``discard=True`` is the staleness-cap degradation path (faults,
        DESIGN.md §16): the arrival still consumes round r and is logged
        with its weight, but the global model is left untouched and no
        kernel launches."""
        self._round += 1
        weight = 1.0
        if self.scheme == "mafl":
            weight = combined_weight(self.p, upload_delay, train_delay)
        if discard:
            pass
        elif self.scheme == "mafl":
            if self.use_kernel:
                self.global_params = aggregation.mafl_update(
                    self.global_params, local_params, self.p.beta, weight,
                    use_kernel=True, interpretation=self.interpretation)
            elif self.interpretation == "literal":
                self.global_params = aggregation.literal_update(
                    self.global_params, local_params, self.p.beta, weight)
            else:
                alpha = float(np.clip((1.0 - self.p.beta) * weight, 0.0, 1.0))
                self.global_params = aggregation.mix_update(
                    self.global_params, local_params, alpha)
        elif self.scheme == "afl":
            self.global_params = aggregation.mix_update(
                self.global_params, local_params, 1.0 - self.p.beta)
        elif self.scheme == "fedasync":
            staleness = max(time - download_time, 0.0)
            alpha = self._fedasync_mix * (staleness + 1.0) ** (-0.5)
            self.global_params = aggregation.mix_update(
                self.global_params, local_params, alpha)
        elif self.scheme == "fedbuff":
            self.global_params, _ = self._fedbuff.add(
                self.global_params, local_params)
        else:
            raise ValueError(f"unknown scheme {self.scheme!r}")
        rec = RoundRecord(self._round, time, vehicle, upload_delay,
                          train_delay, weight)
        self.rounds.append(rec)
        return rec

    @property
    def round(self) -> int:
        return self._round
