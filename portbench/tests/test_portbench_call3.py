"""The three-sample call cell (``relapse_l2fc.call3``) on the CPU at a test's
size: the port agrees with the plain reference, l2fc events included; the
control (the reference in bfloat16 in the port's place) fails a limit; a
run whose timed path is broken underneath comes out not correct (half of
each window left out; the l2fc predicate's comparison reversed in the
port's masks); the reference's l2fc predicate on known values; the l2fc
loop's readers on a record and a ``tracing`` log made by hand; and the cell
on the card (``-m cuda``)."""

from __future__ import annotations

import ast
import copy
import sys

import numpy as np
import pytest
import torch

import varlociraptor_tpu_torch
from portbench.lib import harness, roofline_lfc
from portbench.reference import call3_model, check_call3, control3
from portbench.tests.test_portbench_checks import _drop_half_of_each_window
from varlociraptor_tpu_torch import tracing

CELL = "relapse_l2fc.call3"
SEED = 2147483911


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(genome_len=64_000, check_loci=48):
    """(bench, cell, config, traffic) of the cell cut to a few dozen loci."""
    bench, cell, config, traffic = harness.load_cell(CELL)
    config, traffic = copy.deepcopy(config), dict(traffic)
    config["genome_len"], traffic["check_loci"] = genome_len, check_loci
    return bench, cell, config, traffic


def run_tiny(work, device="cpu", traced=False, seconds=0.1):
    bench, cell, config, traffic = tiny_cell()
    e2e, layer = harness.cell_metrics(bench, cell)
    return harness.run_cell(cell, config, traffic, e2e, layer, SEED, seconds, traced, work,
                            harness.process_start(), device)


def test_port_agrees_with_the_reference(tmp_path):
    out, checks = run_tiny(tmp_path)
    assert out["correct"], checks
    assert out["attempted"] > 0 and list(out)[-1] == "checks"


def test_the_draw_plants_every_class():
    _, _, config, _ = tiny_cell(genome_len=2_000_000)
    from portbench.lib import calls_input3

    inputs = calls_input3.draw(config, SEED)
    assert set(inputs["truth"]) == set(config["call_input"]["mix"])
    assert list(inputs["samples"]) == ["tumor", "relapse", "normal"]
    kind = inputs["truth"]
    vaf = calls_input3.allele_frequencies(
        config, np.array([list(config["call_input"]["mix"]).index(k) for k in kind]),
        list(config["call_input"]["mix"]))
    expanded = kind == "expanded"
    assert np.allclose(vaf["tumor"][expanded], 0.75 * 0.2 * 0.5)
    assert np.allclose(vaf["relapse"][expanded], 0.6 * 1.0 * 0.5)
    assert not vaf["normal"][kind != "germline_het"].any()


def test_control_fails_a_limit():
    _, _, config, traffic = tiny_cell(genome_len=200_000, check_loci=100)
    got = control3.control(config, traffic, 7)
    assert any(got[n] > check_call3.LIMITS[n] for n in got), got


def _reverse_the_l2fc_comparison(monkeypatch):
    from varlociraptor_tpu_torch.ops.event_program import LfcConstraint

    holds = LfcConstraint.holds
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}

    def reversed_holds(self, vaf_a, vaf_b):
        return holds(LfcConstraint(self.sample_a, self.sample_b, flip[self.op], self.value),
                     vaf_a, vaf_b)

    monkeypatch.setattr(LfcConstraint, "holds", reversed_holds)


FAULTS = {"half_left_out": _drop_half_of_each_window,
          "l2fc_reversed": _reverse_the_l2fc_comparison}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    out, checks = run_tiny(tmp_path)
    assert out["correct"] is False, checks


def test_l2fc_predicate_zeros_and_cut_points():
    lfc = call3_model.log2_fold_change
    assert lfc(0.0, 0.0) == 0.0
    assert lfc(0.3, 0.0) == np.inf and lfc(0.0, 0.3) == -np.inf
    assert lfc(0.4, 0.2) == 1.0 and lfc(0.2, 0.4) == -1.0
    holds = call3_model.l2fc_holds
    # the cut points: a doubling is stable, not expanded; a halving too
    assert holds(">=", -1, 0.2, 0.4) and holds("<=", 1, 0.4, 0.2)
    assert not holds(">", 1, 0.4, 0.2) and not holds("<", -1, 0.2, 0.4)
    assert holds(">", 1, 0.41, 0.2) and holds("<", -1, 0.19, 0.4)
    # both at zero: log 0, inside [-1, 1]; one at zero: beyond every cut
    assert holds(">=", -1, 0.0, 0.0) and holds("<=", 1, 0.0, 0.0)
    assert holds(">", 1, 0.1, 0.0) and holds("<", -1, 0.0, 0.1)


def test_the_scenario_masks_split_the_somatic_plane():
    _, _, config, _ = tiny_cell()
    sc = call3_model.Scenario(config["scenario"], config["resolution"])
    assert sc.names == ["tumor", "relapse", "normal"] and sc.root == 2
    assert len(sc.values[0]) == len(sc.values[1]) == 101
    masks = {e: sc.mask(sc.branches[e][0][1])
             for e in ("somatic_stable", "somatic_expanded", "somatic_receded")}
    assert all(m[:2] == (1, 0) for m in masks.values())  # (relapse, tumor)
    total = sum(m[2].astype(int) for m in masks.values())
    assert (total == 1).all()  # every (relapse, tumor) point in exactly one
    grid = sc.values[0].astype(np.float64)  # the tumor's and the relapse's
    i01, i05 = np.argmin(abs(grid - 0.1)), np.argmin(abs(grid - 0.5))
    # [relapse, tumor]: 0.1 -> 0.5 expanded, 0.5 -> 0.1 receded
    assert masks["somatic_expanded"][2][i05, i01] and masks["somatic_receded"][2][i01, i05]


S = 1_000_000_000  # ns
WINDOW = {"window_ns": (0, 10 * S), "window_s": 10.0, "units": 2000}


def _log(counters, t=5 * S):
    log = tracing.Log()
    for name, n in counters.items():
        log.put(log.slot(), (name, "vlt-drain", t, t, -1, 0, n))
    return log


COUNTERS = {"engine.lfc_stream_ns": 4 * S, "engine.lfc_cells": int(roofline_lfc.PEAK_EXP),
            "engine.lfc_bytes": int(roofline_lfc.PEAK_BYTES // 10)}
EXPECTED = {
    # 4 s of stream time over 2,000 loci
    "engine.lfc_ms_per_1k_loci": 2000.0,
    # bound by the exponentials: 1 s of 4 (operations 0.31 s, bytes 0.1 s)
    "lfc.roofline_share": 25.0,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_value(monkeypatch, metric):
    monkeypatch.setattr(tracing, "LOG", _log(COUNTERS))
    assert harness.read_metric(metric, dict(WINDOW)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
@pytest.mark.parametrize("case", ["no_counters", "outside", "no_window", "no_tracing"])
def test_reader_none(monkeypatch, metric, case):
    rec, log = dict(WINDOW), _log(COUNTERS)
    if case == "no_counters":
        log = _log({"call.loci": 2000})
    elif case == "outside":
        log = _log(COUNTERS, t=20 * S)
    elif case == "no_window":
        del rec["window_ns"]
    else:  # a program without the module: importing it fails
        monkeypatch.setitem(sys.modules, "varlociraptor_tpu_torch.tracing", None)
        monkeypatch.delattr(varlociraptor_tpu_torch, "tracing")
    monkeypatch.setattr(tracing, "LOG", log)
    assert harness.read_metric(metric, rec) is None


def test_the_roofline_binds_by_the_largest_term():
    r = roofline_lfc.lfc_roofline(10**9, 10**6)
    assert r["bound_by"] == "exponentials"
    assert r["bound_s"] == pytest.approx(1e9 / (132 * 16 * 1.98e9))
    assert roofline_lfc.lfc_roofline(10, 3.35e12)["bound_by"] == "bytes"


@pytest.mark.parametrize("name", ["call3_model.py", "check_call3.py", "control3.py"])
def test_new_reference_imports_neither_jax_nor_the_program(name):
    path = harness.PB / "reference" / name
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    refused = {"jax", "jaxlib", "flax", "varlociraptor_tpu", "varlociraptor_tpu_torch"}
    assert not {m.split(".")[0] for m in mods} & refused


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out, checks = run_tiny(tmp_path, device="cuda", traced=True, seconds=1.0)
    assert out["correct"], checks
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    share = out["metrics"]["lfc.roofline_share"]["value"]
    assert 0 < share <= 100 and out["metrics"]["engine.lfc_ms_per_1k_loci"]["value"] > 0
