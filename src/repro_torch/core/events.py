"""Event-driven asynchronous scheduler.

A GPU runs bulk-synchronous programs, so wall-clock asynchrony is
*simulated*: every vehicle's (train -> upload) cycle produces an
upload-completion event at

    t_done = t_download + C_l^i + C_u^i(t_upload_start)

and the RSU consumes events in time order — exactly the paper's arrival
semantics (Fig. 2), with each local-training burst itself a synchronous
run of l SGD steps on the device.  See DESIGN.md §2 (hardware adaptation).

The vehicle-batched engine (DESIGN.md §3) additionally stashes the result of
a wave-trained local update on the event itself (``local_params`` /
``local_loss``): an event's payload snapshot is frozen at schedule time, so
its local training is independent of every other pending event and can be
computed early without changing the time-ordered aggregation semantics.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional


@dataclass(order=True)
class UploadEvent:
    time: float
    seq: int
    vehicle: int = field(compare=False)          # 0-based
    download_time: float = field(compare=False, default=0.0)
    train_delay: float = field(compare=False, default=0.0)
    upload_delay: float = field(compare=False, default=0.0)
    payload: Any = field(compare=False, default=None)
    # which train/upload cycle of this vehicle the event belongs to
    cycle: int = field(compare=False, default=0)
    # wave-precomputed local update (vehicle-batched engine only)
    local_params: Any = field(compare=False, default=None, repr=False)
    local_loss: Optional[float] = field(compare=False, default=None)


class EventQueue:
    def __init__(self):
        self._heap: list[UploadEvent] = []
        self._seq = 0

    def push(self, time: float, vehicle: int, **kw) -> UploadEvent:
        ev = UploadEvent(time=time, seq=self._seq, vehicle=vehicle, **kw)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> UploadEvent:
        return heapq.heappop(self._heap)

    def peek(self) -> UploadEvent:
        return self._heap[0]

    def pending(self) -> Iterator[UploadEvent]:
        """All queued events, unordered (the heap as-is)."""
        return iter(self._heap)

    def earliest_time(self) -> float:
        return self._heap[0].time if self._heap else float("inf")

    def as_struct_arrays(self) -> dict:
        """Pending events as structure-of-arrays, sorted by (time, seq).

        The columnar face of the queue: the device-resident engine
        (DESIGN.md §9) seeds its fixed-capacity slot arrays from this —
        payloads are deliberately excluded (the jit engine keeps snapshots
        in its own device-side ring)."""
        import numpy as np
        evs = sorted(self._heap, key=lambda e: (e.time, e.seq))
        return {
            "time": np.array([e.time for e in evs], np.float64),
            "vehicle": np.array([e.vehicle for e in evs], np.int32),
            "download_time": np.array([e.download_time for e in evs],
                                      np.float64),
            "train_delay": np.array([e.train_delay for e in evs],
                                    np.float64),
            "upload_delay": np.array([e.upload_delay for e in evs],
                                     np.float64),
            "cycle": np.array([e.cycle for e in evs], np.int32),
        }

    def __len__(self):
        return len(self._heap)
