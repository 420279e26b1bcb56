"""The trace reader: the device's busy time is the union of its intervals,
ranges mirrored from the host are not device work, kernels are summed by
name, and idle gaps are named by what the host did in their middle."""
from __future__ import annotations

import pytest

from portbench.harness import trace


class _Event:
    def __init__(self, name, device, start_us, dur_us, annotation=False):
        self._n, self._d, self._s, self._u = name, device, start_us, dur_us
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def activity_type(self):
        return "user_annotation" if self._a else "kernel"

    def is_user_annotation(self):
        return self._a

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return self._u * 1000


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_union_names_and_gaps():
    events = [
        _Event("portbench.episode", True, 0, 1000, annotation=True),
        _Event("portbench.episode", False, 0, 1000, annotation=True),
        _Event("aten::mm", False, 400, 200),
        _Event("cudaStreamSynchronize", False, 420, 100),
        _Event("ring_agg_kernel<float>", True, 0, 100),
        _Event("ring_agg_kernel<float>", True, 50, 100),     # overlaps
        _Event("weighted_agg_kernel<float>", True, 300, 100),
        _Event("gemm", True, 700, 50),
    ]
    tr = trace.read(_Prof(events))
    # union: [0, 150] + [300, 400] + [700, 750] = 300 us
    assert tr.busy_s == pytest.approx(300e-6)
    assert tr.kernel_seconds("ring_agg_kernel") == pytest.approx(200e-6)
    assert tr.kernel_seconds("weighted_agg_kernel") == pytest.approx(100e-6)
    assert tr.kernel_seconds("cross_entropy_kernel") is None
    assert "portbench.episode" not in tr.device_by_name
    # gaps: 400-700 (300 us, middle 550: aten::mm), 150-300 (middle 225:
    # only the episode's range)
    assert tr.gaps[0] == ("aten::mm", pytest.approx(300e-6))
    assert tr.gaps[1] == ("portbench.episode", pytest.approx(150e-6))
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "ring_agg_kernel<float>"
    assert len(b["idle_gaps"]) == 2


def test_no_device_work():
    tr = trace.read(_Prof([_Event("aten::add", False, 0, 10)]))
    assert tr.busy_s == 0.0 and tr.gaps == [] and tr.device_by_name == {}
