"""The frozen roofline arithmetic on known shapes, the trace reduction on
made-up profiler events, and the per-layer readers on a made-up record."""

from __future__ import annotations

import math

import pytest
from torch.autograd import DeviceType

from portbench.lib import harness, roofline, trace


def test_k1_at_the_call_window_shape():
    # PERF.md: 0.0167 ms at 4096 rows (1.12e9 ops, 15.8 MB), bound by operations
    r = roofline.k1_roofline(4096, 711, 64)
    assert r["ops"] == 6 * 4096 * 711 * 64 + 2 * 4096 * 64 + 711
    assert r["bytes"] == 4 * (4 * 4096 * 64 + 2 * 711 + 4096 * 711)
    assert r["bound_by"] == "operations"
    assert r["bound_s"] * 1e3 == pytest.approx(0.0167, abs=5e-5)


def test_k1_at_the_engine_bench_shape():
    # PERF.md: 0.534 ms at 131072 x 711 x 64 (3.58e10 ops, 507 MB)
    r = roofline.k1_roofline(131072, 711, 64)
    assert r["ops"] == pytest.approx(3.58e10, rel=2e-3)
    assert r["bytes"] == pytest.approx(507e6, rel=2e-3)
    assert r["bound_s"] * 1e3 == pytest.approx(0.534, abs=1e-3)


def test_k3_counts_sixteen_operations_a_cell():
    r = roofline.pairhmm_roofline("general", 4408 * 128 * 100, 1_750_000, 4408)
    assert r["ops"] == 16 * 4408 * 128 * 100 and r["bytes"] == 1_750_000 + 4 * 4408
    assert r["bound_s"] == pytest.approx(r["ops"] / 67e12)
    b = roofline.pairhmm_roofline("exact", 10, 3.35e12, 0)
    assert b["bound_by"] == "bytes" and b["bound_s"] == pytest.approx(1.0)


class Event:
    def __init__(self, name, start_us, end_us, on_device):
        self._n, self._s, self._e, self._d = name, start_us, end_us, on_device

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return (self._e - self._s) * 1000


def test_reduce_cuts_to_the_window_and_splits_idle_by_span():
    ev = [
        Event(trace.WINDOW, 100, 1100, False),
        Event(trace.WINDOW, 100, 1100, True),           # the annotation copy
        Event("pb.call_generic", 100, 900, False),
        Event("pb.engine", 200, 400, False),
        Event("kernel_a", 50, 150, True),                # half before the window
        Event("kernel_a", 250, 350, True),
        Event("Memcpy HtoD (Pageable -> Device)", 300, 500, True),  # overlaps
        Event("Activity Buffer Request", 600, 700, True),
    ]
    r = trace.reduce_events(ev)
    assert r["busy_s"] == pytest.approx((50 + 250) * 1e-6)
    assert r["kernels"]["kernel_a"] == [pytest.approx(150e-6), 2]
    idle = dict(r["idle_gaps"])
    # gaps: 150-250 (engine 200-250, call_generic 150-200), 500-1100
    assert idle["engine"] == pytest.approx(50e-6)
    assert idle["call_generic"] == pytest.approx((50 + 400) * 1e-6)
    assert idle["harness"] == pytest.approx(200e-6)
    assert sum(idle.values()) + r["busy_s"] == pytest.approx(1000e-6)
    assert r["device_ops"][0][0] == "Memcpy HtoD (Pageable -> Device)"


def test_readers_on_a_made_up_record():
    rec = {"window_s": 2.0, "units": 4000, "busy_s": 0.5, "loop_steps": 100,
           "k1_launches": [(4096, 711, 64)],
           "kernels": {"(anonymous namespace)::ll_classes_kernel(float const*)": [2 * 1.67e-5, 1],
                       "Memcpy HtoD (Pageable -> Device)": [0.004, 8]}}
    read = lambda name: harness.read_metric(name, rec)  # noqa: E731
    assert read("k1.roofline_share") == pytest.approx(50.0, rel=1e-2)
    assert read("device_idle_share.call") == pytest.approx(75.0)
    assert read("engine.h2d_ms_per_1k_loci") == pytest.approx(1.0)
    assert not math.isnan(read("k1.roofline_share"))
