"""What a run records: one :class:`Episode` per call of the cell's entry,
and the :class:`Run` that the per-layer metric readers read."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Episode:
    """One complete call of the cell's entry in the measured window.

    ``counts`` holds the work it did, in the entry's own units (``rounds``
    merged into global models summed over worlds, ``samples`` and
    ``tokens`` trained, ``merges``, ``steps``, ...); ``phases`` the
    program's phase timers (``telemetry/timers.py``); ``wall`` the
    harness's clock around the call, which ends when the card is done."""
    index: int
    seed: int
    counts: dict
    phases: dict = field(default_factory=dict)
    wall: float = 0.0
    output: object = None        # what the comparison reads, or None


@dataclass
class Run:
    """A measured window: its episodes, its length, the kernels' launches
    in it (``kernels.launch_counts()`` deltas), the traced device activity
    (``--trace 1`` runs) and the cell."""
    cell: object
    episodes: list
    window_s: float
    launches: dict
    trace: object = None

    def total(self, key: str) -> float:
        return sum(ep.counts.get(key, 0) for ep in self.episodes)

    def phase(self, key: str) -> float:
        return sum(ep.phases.get(key, 0.0) for ep in self.episodes)
