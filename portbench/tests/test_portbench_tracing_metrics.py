"""The readers of the program's spans and counters on a record and a
``varlociraptor_tpu_torch.tracing`` log made by hand: each gives its value,
and None without the window's interval, with no loci, with records dropped,
or where the program has no ``tracing`` module."""

from __future__ import annotations

import json
import sys

import pytest

import varlociraptor_tpu_torch
from portbench.lib import harness
from varlociraptor_tpu_torch import tracing

S = 1_000_000_000  # ns
MAIN, DRAIN = "MainThread", "vlt-drain"
LOG = [  # index: (name, thread, start, end, parent, window, n)
    ("call.generic", MAIN, 1 * S, 9 * S, -1, -1, None),                 # 0
    ("call.read", MAIN, 1 * S, S + S // 2, 0, 0, None),                  # 1: 0.5 s
    ("call.pack", MAIN, S + S // 2, 3 * S + S // 2, 0, 0, None),         # 2: 2 s, 1 s own
    ("engine.dispatch", MAIN, 2 * S, 3 * S, 2, 0, None),                 # 3: 1 s
    ("engine.h2d_bytes", MAIN, 2 * S, 2 * S, 3, 0, 3_000_000),           # 4
    ("call.windows", MAIN, 3 * S, 3 * S, 0, 0, 1),                       # 5
    ("call.windows", MAIN, 3 * S, 3 * S, 0, 1, 1),                       # 6
    ("call.loci", MAIN, 3 * S, 3 * S, 0, 0, 2000),                       # 7
    ("call.wait_drain", MAIN, 3 * S + S // 2, 7 * S + S // 2, 0, 0, None),  # 8: 4 s
    ("call.drain", DRAIN, 1 * S, 9 * S, -1, -1, None),                   # 9: 8 s
    ("call.wait_main", DRAIN, 1 * S, 3 * S, 9, 0, None),                 # 10: 2 s
    ("engine.fetch", DRAIN, 3 * S, 3 * S + S // 2, 9, 0, None),         # 11: 0.5 s
    ("call.format", DRAIN, 3 * S + S // 2, 8 * S + S // 2, 9, 0, None),  # 12: 5 s
    ("fdr.control", MAIN, 9 * S, 9 * S + 8 * S // 10, -1, -1, None),    # 13: 0.8 s
    ("call.read", MAIN, 20 * S, 30 * S, -1, 5, None),                   # 14: outside
]
RECORD = {
    "window_ns": (0, 10 * S), "window_s": 10.0, "units": 2000,
    "kernels": {"ll_classes_kernel": [0.1, 150], "elementwise": [0.2, 50],
                "Memcpy HtoD (Pageable -> Device)": [0.01, 20], "Memset (Device)": [0.0, 5]},
}
EXPECTED = {  # ms per 1,000 loci = 1e3 * seconds / 2
    "call.read_ms_per_1k_loci": 250.0,
    "call.pack_ms_per_1k_loci": 500.0,
    "engine.dispatch_ms_per_1k_loci": 500.0,
    "engine.fetch_ms_per_1k_loci": 250.0,
    "call.format_ms_per_1k_loci": 2500.0,
    "fdr.ms_per_1k_loci": 400.0,
    "call.main_waits_drain_share": 50.0,
    "call.drain_waits_main_share": 25.0,
    "engine.launches_per_window": 100.0,
    "engine.h2d_bytes_per_locus": 1500.0,
}


def _log(cap=None, extra=0):
    log = tracing.Log(cap or len(LOG))
    for r in LOG:
        log.put(log.slot(), r)
    for _ in range(extra):
        log.slot()
    return log


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_value(monkeypatch, metric):
    monkeypatch.setattr(tracing, "LOG", _log())
    assert harness.read_metric(metric, dict(RECORD)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
@pytest.mark.parametrize("case", ["no_window", "no_units", "dropped", "no_tracing"])
def test_reader_none(monkeypatch, metric, case):
    rec = dict(RECORD)
    log = _log()
    if case == "no_window":
        del rec["window_ns"]
    elif case == "no_units":
        rec["units"] = 0
    elif case == "dropped":  # a drop inside the window
        log = _log(extra=1)
        rec["window_ns"] = (0, log.drops_ns[1])
    else:  # a program without the module: importing it fails
        monkeypatch.setitem(sys.modules, "varlociraptor_tpu_torch.tracing", None)
        monkeypatch.delattr(varlociraptor_tpu_torch, "tracing")
    monkeypatch.setattr(tracing, "LOG", log)
    assert harness.read_metric(metric, rec) is None


def test_every_reader_is_in_the_benchmark():
    layer = {m["name"]: m for m in json.loads(
        (harness.ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for name in EXPECTED:
        assert layer[name]["workloads"] == ["tumor_normal.call"]
        assert layer[name]["moves"] == "call_device_ms_per_1k_loci"
