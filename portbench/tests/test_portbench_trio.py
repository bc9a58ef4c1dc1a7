"""The trio cell (``trio_denovo.call_full_prior``) on the CPU at a test's
size: the port's ``call_generic --full-prior`` agrees with the plain
reference at resolutions 0.1 and 0.05; the control (the reference in
bfloat16 in the port's place) fails a limit; a run whose timed path is
broken underneath comes out not correct (half of each window left out; the
Mendelian term dropped from the port's joint prior, the child counted in
the population prior instead); the reference's prior against upstream's
rules at hand-checked points; the draw; the stage's refusal of a program
whose warm-up call outlasts its deadline (a table built cell by cell); the
configuration's scenario, the port's own trio; the new readers on a record
and a ``tracing`` log made by hand; and the cell on the card
(``-m cuda``)."""

from __future__ import annotations

import ast
import copy
import math
import sys
import time

import numpy as np
import pytest
import torch

import varlociraptor_tpu_torch
from portbench.lib import harness, roofline_full_prior, stage_trio
from portbench.reference import check_trio, control_trio, trio_model
from portbench.tests.test_portbench_checks import _drop_half_of_each_window
from varlociraptor_tpu_torch import tracing

CELL = "trio_denovo.call_full_prior"
SEED = 2147483911


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(genome_len=128_000, check_loci=128, resolution=0.1):
    """(bench, cell, config, traffic) of the cell cut to a test's size: 128
    loci at a coarser resolution (1,331 or 9,261 joint cells a locus)."""
    bench, cell, config, traffic = harness.load_cell(CELL)
    config, traffic = copy.deepcopy(config), dict(traffic)
    config["genome_len"], traffic["check_loci"] = genome_len, check_loci
    config["resolution"] = resolution
    return bench, cell, config, traffic


def run_tiny(work, device="cpu", traced=False, seconds=0.1, resolution=0.1):
    bench, cell, config, traffic = tiny_cell(resolution=resolution)
    e2e, layer = harness.cell_metrics(bench, cell)
    return harness.run_cell(cell, config, traffic, e2e, layer, SEED, seconds, traced, work,
                            harness.process_start(), device)


@pytest.mark.parametrize("resolution", [0.1, 0.05])
def test_port_agrees_with_the_reference(tmp_path, resolution):
    out, checks = run_tiny(tmp_path, resolution=resolution)
    assert out["correct"], checks
    assert out["attempted"] > 0 and list(out)[-1] == "checks"


def test_the_draw_plants_every_class():
    _, _, config, _ = tiny_cell(genome_len=2_000_000)
    from portbench.lib import calls_input_trio

    inputs = calls_input_trio.draw(config, SEED)
    assert set(inputs["truth"]) == set(config["call_input"]["mix"])
    assert list(inputs["samples"]) == ["child", "father", "mother"]
    m, f, c = calls_input_trio.genotypes(np.random.default_rng(1), 20000, 0.3)
    assert not ((m == 0) & (f == 0)).any()
    # a child has one allele of each parent
    assert ((c >= (m == 2).astype(int) + (f == 2)) & (c <= (m > 0).astype(int) + (f > 0))).all()


def test_control_fails_a_limit():
    _, _, config, traffic = tiny_cell(genome_len=200_000, check_loci=100)
    got = control_trio.control(config, traffic, 7)
    assert any(got[n] > check_trio.LIMITS[n] for n in got), got


def _drop_the_mendelian_term(monkeypatch):
    """The port's priors without inheritance: the child joins the parents in
    the population prior and keeps its somatic term."""
    from varlociraptor_tpu_torch.calling import call

    build = call.build_prior

    def no_inheritance(*args, **kw):
        prior = build(*args, **kw)
        prior.inheritance = [None] * prior.n_samples
        return prior

    monkeypatch.setattr(call, "build_prior", no_inheritance)


FAULTS = {"half_left_out": _drop_half_of_each_window,
          "mendelian_dropped": _drop_the_mendelian_term}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    out, checks = run_tiny(tmp_path)
    assert out["correct"] is False, checks
    moved = {"half_left_out": "records_missing", "mendelian_dropped": "prob_gap"}[fault]
    assert dict((n, v > lim) for n, v, lim in checks)[moved], checks


def test_a_program_that_builds_the_table_cell_by_cell_is_refused(tmp_path, monkeypatch):
    """A program whose first call outlasts the deadline (here its table
    build slowed past a deadline cut to a test's size) fails set-up at the
    deadline, not at the run's time limit."""
    from varlociraptor_tpu_torch.calling.call import GenericCaller

    build = GenericCaller._full_prior_table

    def slow(self, *a, **kw):
        time.sleep(30)
        return build(self, *a, **kw)

    monkeypatch.setattr(GenericCaller, "_full_prior_table", slow)
    monkeypatch.setattr(stage_trio, "FIRST_CALL_S", 2.0)
    t = time.perf_counter()
    with pytest.raises(TimeoutError, match="warm-up call"):
        run_tiny(tmp_path)
    assert time.perf_counter() - t < 20


def test_the_scenario_is_the_ports_trio():
    """The configuration's scenario is the one the port's own checks and
    ``chip_smoke.py`` run (``bench_utils.TRIO_DENOVO_SCENARIO``)."""
    from varlociraptor_tpu_torch.bench_utils import TRIO_DENOVO_SCENARIO

    _, _, config, _ = harness.load_cell(CELL)
    assert config["scenario"] == TRIO_DENOVO_SCENARIO
    assert config["resolution"] == 0.01


def test_reference_prior_at_hand_checked_points():
    """The reference's joint prior at the grid points of genotypes, against
    upstream's rules written out for a trio of ploidy 2."""
    _, _, config, _ = tiny_cell()
    sc = trio_model.Scenario(config["scenario"], 0.1)
    assert sc.names == ["child", "father", "mother"] and sc.parents == [(2, 1), None, None]
    assert [len(b) for b in sc.branches.values()] == [1, 1, 1, 6]
    c, F = trio_model.prior_factors(sc)
    v = sc.values[0].astype(np.float64)

    def prior(vc, vf, vm):
        i = [int(np.argmin(abs(v - x))) for x in (vc, vf, vm)]
        return float((c * F[0][:, i[0]] * F[1][:, i[1]] * F[2][:, i[2]]).sum())

    h, mu, r = 0.001, 1e-3, 1e-6
    absent = 1 - h * (1 + 1 / 2 + 1 / 3 + 1 / 4)
    # de novo het: parents hom-ref, the child one de novo allele (or somatic)
    want = absent * (mu * (1 - r) ** 3 + 1 * r * (1 - r) ** 2)
    assert prior(0.5, 0.0, 0.0) == pytest.approx(want, rel=1e-3)
    # a het mother (one allele among the parents: h / 1), the child inherits
    # her alternative allele with probability 1/2
    want_inh = h * 0.5 * (1 - r) ** 3
    assert prior(0.5, 0.0, 0.5) == pytest.approx(want_inh, rel=1e-2)
    # the whole grid of genotype points sums to (nearly) 1: each factor of a
    # point of the somatic mass is 1 - r, and the Mendelian terms sum to 1
    # over the child's genotypes at mu -> 0
    pts = [0.0, 0.5, 1.0]
    total = sum(prior(a, b, d) for a in pts for b in pts for d in pts)
    assert total == pytest.approx(1.0, abs=5e-3)


S = 1_000_000_000  # ns
WINDOW = {"window_ns": (0, 10 * S), "window_s": 10.0, "units": 2000}


def _log(counters, t=5 * S, spans=()):
    log = tracing.Log()
    for name, n in counters.items():
        log.put(log.slot(), (name, "vlt-main", t, t, -1, 0, n))
    for name, dur in spans:
        log.put(log.slot(), (name, "vlt-main", t, t + dur, -1, 0, None))
    return log


COUNTERS = {"engine.full_prior_stream_ns": 4 * S,
            "engine.full_prior_cells": int(roofline_full_prior.PEAK_F32_OPS / 2),
            "engine.full_prior_bytes": int(roofline_full_prior.PEAK_BYTES // 10)}
SPANS = [("call.prior_table", S // 2)]
EXPECTED = {
    # 4 s of stream time over 2,000 loci
    "engine.full_prior_ms_per_1k_loci": 2000.0,
    # bound by the operations: 1 s of 4 (bytes 0.1 s)
    "full_prior.roofline_share": 25.0,
    # 0.5 s of tables over 2,000 loci
    "call.prior_table_ms_per_1k_loci": 250.0,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_value(monkeypatch, metric):
    monkeypatch.setattr(tracing, "LOG", _log(COUNTERS, spans=SPANS))
    assert harness.read_metric(metric, dict(WINDOW)) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
@pytest.mark.parametrize("case", ["nothing", "outside", "no_window", "no_tracing"])
def test_reader_none(monkeypatch, metric, case):
    rec, log = dict(WINDOW), _log(COUNTERS, spans=SPANS)
    if case == "nothing":
        log = _log({"call.loci": 2000})
    elif case == "outside":
        log = _log(COUNTERS, t=20 * S, spans=SPANS)
    elif case == "no_window":
        del rec["window_ns"]
    else:  # a program without the module: importing it fails
        monkeypatch.setitem(sys.modules, "varlociraptor_tpu_torch.tracing", None)
        monkeypatch.delattr(varlociraptor_tpu_torch, "tracing")
    monkeypatch.setattr(tracing, "LOG", log)
    assert harness.read_metric(metric, rec) is None


def test_the_roofline_binds_by_the_larger_term():
    r = roofline_full_prior.full_prior_roofline(10**12, 10**6)
    assert r["bound_by"] == "operations"
    assert r["bound_s"] == pytest.approx(2e12 / 67e12)
    assert roofline_full_prior.full_prior_roofline(10, 3.35e12)["bound_by"] == "bytes"


@pytest.mark.parametrize("name", ["trio_model.py", "check_trio.py", "control_trio.py"])
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
    share = out["metrics"]["full_prior.roofline_share"]["value"]
    assert 0 < share <= 100 and out["metrics"]["engine.full_prior_ms_per_1k_loci"]["value"] > 0
    assert out["metrics"]["call.prior_table_ms_per_1k_loci"]["value"] > 0
    assert not math.isnan(share)
