"""BENCHMARK.json against the contract's shape, and the discovery of every
configuration, traffic mix, stage and per-layer metric by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench.lib import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
    lines = [x[k] for x in BENCH["configs"] + BENCH["workloads"] for k in ("why", "source")
             if k in x] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in lines)

@pytest.mark.parametrize("cell", CELLS)
def test_cell_discovery(cell):
    bench, entry, config, traffic = harness.load_cell(cell)
    assert config["name"] == entry["config"]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    assert conf["file"].startswith("portbench/configs/")
    assert set(conf["reduced"]) == set(config["reduced"])
    assert (harness.PB / "lib" / f"stage_{traffic['stage']}.py").exists()
    e2e, layer = harness.cell_metrics(bench, entry)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and set(traffic["end_to_end"]) <= set(names)
    assert len(names) == 1 + len(traffic["end_to_end"])
    assert set(traffic["end_to_end"].values()) <= set(harness.QUANTITIES)
    assert layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", LAYER)
def test_metric_reader_found_by_name(metric):
    assert harness.read_metric(metric, {"window_s": 1.0, "units": 0}) is None


def test_every_metric_file_is_named_in_the_benchmark():
    files = {p.stem for p in (harness.PB / "metrics").glob("*.py")}
    assert files == set(LAYER)
    used = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (harness.PB / "traffic").glob("*.json")} == used
    assert {p.stem for p in (harness.PB / "configs").glob("*.json")} == {
        c["name"] for c in BENCH["configs"]}
