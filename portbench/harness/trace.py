"""Reading a ``torch.profiler`` trace of the measured window.

The harness profiles the whole window of a ``--trace 1`` run.  From the
trace it takes the device's activity (kernels, copies and sets on the
card) as intervals: their union is the time the device was busy, the
rest of the window is idle.  Device time by name gives each kernel's own
time; the longest idle gaps are named by the innermost host operation that
was running at the gap's middle (the harness's own spans around each call
into the program are such operations).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Trace:
    busy_s: float = 0.0
    device_by_name: dict = field(default_factory=dict)   # name -> seconds
    gaps: list = field(default_factory=list)             # [(name, seconds)]

    def kernel_seconds(self, fragment: str) -> float | None:
        """Summed device time of every kernel whose name holds
        ``fragment``; None when none ran."""
        hits = [s for n, s in self.device_by_name.items() if fragment in n]
        return sum(hits) if hits else None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_by_name.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


def _annotation(e) -> bool:
    """A user's range (``record_function``) mirrored onto the device's
    timeline: no work of the device."""
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return True
    if hasattr(e, "activity_type"):
        return "annotation" in str(e.activity_type()).lower()
    return e.name().startswith("portbench.")


def _events(prof):
    """(name, is_device, start_us, dur_us) of every event, read from the
    profiler's own records without building its Python event tree; the
    device's copies of host ranges count as host events."""
    results = prof.profiler.kineto_results
    out = []
    for e in results.events():
        dev = str(e.device_type()).endswith("CUDA") and not _annotation(e)
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
        dur = (e.duration_ns() / 1e3 if hasattr(e, "duration_ns")
               else e.duration_us())
        out.append((e.name(), dev, float(start), float(dur)))
    return out


def read(prof, top: int = 10) -> Trace:
    events = _events(prof)
    dev = [(n, s, d) for n, is_dev, s, d in events if is_dev and d > 0]
    host = [(n, s, d) for n, is_dev, s, d in events if not is_dev and d > 0]
    tr = Trace()
    if not dev:
        return tr
    for n, _s, d in dev:
        tr.device_by_name[n] = tr.device_by_name.get(n, 0.0) + d / 1e6
    starts = np.array([s for _n, s, _d in dev])
    ends = starts + np.array([d for _n, _s, d in dev])
    order = np.argsort(starts)
    starts, ends = starts[order], ends[order]
    # union of the device intervals
    run_end = np.maximum.accumulate(ends)
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > run_end[:-1]
    seg_start = starts[new]
    seg_end = np.append(run_end[np.flatnonzero(new)[1:] - 1], run_end[-1])
    tr.busy_s = float(np.sum(seg_end - seg_start)) / 1e6
    gap_len = seg_start[1:] - seg_end[:-1]
    idx = np.argsort(-gap_len)[:top]
    # what the host did in a gap: the innermost operation around its middle
    # other than a call into the CUDA runtime
    host = [h for h in host if not h[0].startswith("cuda")]
    if host:
        h_start = np.array([s for _n, s, _d in host])
        h_dur = np.array([d for _n, _s, d in host])
        h_name = [n for n, _s, _d in host]
    for i in idx:
        at = (seg_end[i] + seg_start[i + 1]) / 2
        name = "no host operation"
        if host:
            cover = np.flatnonzero((h_start <= at) & (h_start + h_dur > at))
            if len(cover):
                name = h_name[cover[np.argmin(h_dur[cover])]]
        tr.gaps.append((name, float(gap_len[i]) / 1e6))
    return tr
