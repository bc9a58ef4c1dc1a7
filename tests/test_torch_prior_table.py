"""The --full-prior joint prior table and the way it reaches the engine.

* ``ops/prior_table.joint_prior_table`` (the whole grid at once, float64)
  equals the scalar ``Prior.compute`` cell for cell: every cell at
  resolutions 0.1 and 0.05 on scenarios that reach each rule (somatic
  rates, germline-only lattices, universes, Mendelian, clonal and subclonal
  inheritance, odd ploidies, a ploidy-0 contig), and 5,000 drawn cells of
  the de novo trio at 0.01;
* the caller keys its tables by what they depend on (ploidies, universes,
  variant type, overrides, grid), not by the contig's name, and builds each
  once in the span ``call.prior_table``;
* the engine's outputs from tables and a per-locus row index are the
  outputs from one table copy a locus (indexed in locus order), bit for
  bit, on the S = 1, 2, 3 and generic routes of ``_full_prior_T``, with the
  trio loop in one locus chunk or several; tables without the index are
  refused.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import pytest
import torch
import yaml

from test_torch_engine_modes import CASES, _mods
from varlociraptor_tpu_torch import bench_utils as tbu
from varlociraptor_tpu_torch import tracing
from varlociraptor_tpu_torch.calling import call as call_mod
from varlociraptor_tpu_torch.calling.call import CallOptions, GenericCaller
from varlociraptor_tpu_torch.calling.variants import VariantInfo
from varlociraptor_tpu_torch.grammar.scenario import Scenario
from varlociraptor_tpu_torch.ops import posterior, prior_table
from varlociraptor_tpu_torch.ops.grid import AFGrid
from varlociraptor_tpu_torch.ops.prior import build_prior, check_prior

TRIO_DENOVO = tbu.TRIO_DENOVO_SCENARIO

SEXED = """
species:
  heterozygosity: 0.001
  germline-mutation-rate: 1e-3
  ploidy:
    male: {all: 2, X: 1, Y: 1}
    female: {all: 2, X: 2, Y: 0}
  genome-size: 3.5e9
samples:
  tumor:
    sex: female
    somatic-effective-mutation-rate: 1e-6
    inheritance: {clonal: {from: normal, somatic: SOMATIC}}
  normal: {sex: female, somatic-effective-mutation-rate: 1e-10}
events:
  somatic: "tumor:]0.0,1.0] & normal:0.0"
"""


def _sexed(somatic):
    return yaml.safe_load(SEXED.replace("SOMATIC", somatic))


SUBCLONAL = {
    "species": {"heterozygosity": 0.001},
    "samples": {
        "normal": {"ploidy": 2, "somatic-effective-mutation-rate": 1e-9},
        "tumor": {"ploidy": 2, "somatic-effective-mutation-rate": 1e-6,
                  "inheritance": {"subclonal": {"from": "normal"}}},
    },
    "events": {"somatic": "tumor:]0.0,1.0] & normal:0.0"},
}

MALE_X_TRIO = {
    "species": {"heterozygosity": 0.001, "germline-mutation-rate": 1e-3,
                "ploidy": {"male": {"all": 2, "X": 1, "Y": 1},
                           "female": {"all": 2, "X": 2, "Y": 0}}},
    "samples": {
        "mother": {"sex": "female", "somatic-effective-mutation-rate": 1e-6},
        "father": {"sex": "male", "somatic-effective-mutation-rate": 1e-6},
        "son": {"sex": "male", "somatic-effective-mutation-rate": 1e-6,
                "inheritance": {"mendelian": {"from": ["mother", "father"]}}},
    },
    "events": {"denovo": "mother:0.0 & father:0.0 & son:1.0"},
}

GERMLINE_TRIO = {
    "species": {"heterozygosity": 0.001, "germline-mutation-rate": 1e-3},
    "samples": {
        "mother": {"ploidy": 2}, "father": {"ploidy": 2},
        "child": {"ploidy": 2, "inheritance": {"mendelian": {"from": ["mother", "father"]}}},
    },
    "events": {"denovo": "mother:0.0 & father:0.0 & child:0.5"},
}

# name -> (scenario, contig)
PRIORS = {
    "trio_denovo": (TRIO_DENOVO, "chr1"),
    "trio_universe": (tbu.TRIO_SCENARIO, "chr1"),
    "clonal": (_sexed("false"), "chr1"),
    "clonal_somatic": (_sexed("true"), "chr1"),
    "clonal_ploidy0": (_sexed("false"), "Y"),
    "subclonal": (SUBCLONAL, "chr1"),
    "male_x_trio": (MALE_X_TRIO, "X"),
    "germline_trio": (GERMLINE_TRIO, "chr1"),
}


def _prior(name, het=None, som=None):
    doc, contig = PRIORS[name]
    prior = build_prior(Scenario(copy.deepcopy(doc)), contig)
    check_prior(prior)
    prior.variant_heterozygosity, prior.variant_somatic_rate = het, som
    return prior


def _values(prior, res):
    return [AFGrid.build(res, extra_points=[0.5]).values for _ in range(prior.n_samples)]


def scalar_prior_table(prior, value_lists):
    """The table from ``prior.compute`` cell by cell (the scalar oracle,
    ~0.5 ms a cell)."""
    shape = tuple(len(v) for v in value_lists)
    table = np.zeros(shape, dtype=np.float64)
    prior.is_absent_only = False
    try:
        for idx in np.ndindex(*shape):
            table[idx] = prior.compute([float(value_lists[s][idx[s]]) for s in range(len(shape))])
    finally:
        prior.is_absent_only = True
    return table


def _same(got, want):
    """Equal to float64 rounding: the sums over genotypes round through
    numpy's exp / log instead of math's (a few ulp of the largest term);
    equal once cast to the float32 that the engine reads."""
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-13, atol=1e-14)
    assert np.array_equal(got.astype(np.float32), want.astype(np.float32))


@pytest.mark.parametrize("res", [0.1, 0.05])
@pytest.mark.parametrize("name", sorted(PRIORS))
def test_table_equals_the_scalar_prior_at_every_cell(name, res):
    prior = _prior(name)
    values = _values(prior, res)
    want = scalar_prior_table(prior, values)
    assert np.isfinite(want).any()
    _same(prior_table.joint_prior_table(prior, values), want)
    # the scalar's own flag is left as it was
    assert prior.is_absent_only


def test_table_follows_the_overrides():
    prior = _prior("trio_denovo", het=0.01, som=1e-4)
    values = _values(prior, 0.1)
    want = scalar_prior_table(prior, values)
    _same(prior_table.joint_prior_table(prior, values), want)
    plain = prior_table.joint_prior_table(_prior("trio_denovo"), values)
    assert not np.allclose(plain, want)


def test_trio_at_the_default_resolution_on_drawn_cells():
    prior = _prior("trio_denovo")
    values = _values(prior, 0.01)
    table = prior_table.joint_prior_table(prior, values)
    assert table.shape == (101, 101, 101) and np.isfinite(table).all()
    rng = np.random.default_rng(20261019)
    cells = rng.integers(0, 101, (5000, 3))
    prior.is_absent_only = False
    want = np.array([prior.compute([values[s][c[s]] for s in range(3)]) for c in cells])
    prior.is_absent_only = True
    _same(table[tuple(cells.T)], want)


def _caller(doc, res=0.1):
    return GenericCaller(Scenario(copy.deepcopy(doc)),
                         CallOptions(full_prior=True, resolution=res), device="cpu")


def _row(caller, contig, kind="snv", het=None):
    events, grid = caller._events_for(contig)
    engine = caller._engine_for(contig, events, grid)
    v = VariantInfo(kind=kind, chrom=contig, pos=0, ref_allele="A", alt_allele="T",
                    heterozygosity=het)
    prior = caller._prior_for(contig, kind)
    prior.variant_heterozygosity = het
    return engine, caller._joint_prior_row(engine, v, prior)


def test_tables_are_keyed_by_what_they_depend_on(monkeypatch):
    built = []
    real = call_mod.joint_prior_table

    def counted(prior, values):
        built.append(tuple(prior.ploidies))
        return real(prior, values)

    monkeypatch.setattr(call_mod, "joint_prior_table", counted)
    caller = _caller(MALE_X_TRIO)
    e1, r1 = _row(caller, "chr1")
    e2, r2 = _row(caller, "chr2")  # other name, same ploidies: the same table
    assert built == [(2, 2, 2)] and r1 == r2 == 0
    _row(caller, "X")  # other ploidies: a table of its own
    assert built == [(2, 2, 2), (1, 2, 1)]
    eh, rh = _row(caller, "chr1", het=0.01)  # an override: a row of its own
    assert len(built) == 3 and eh is e1 and rh != r1
    tables = caller._joint_prior_tables(e1)
    assert tables.dtype == torch.float32
    assert tables.shape == (len(caller._prior_rows[id(e1)]["rows"]), 11, 11, 11)
    assert not torch.equal(tables[r1], tables[rh])
    # the device copy is made once and again only when a row is added
    assert caller._joint_prior_tables(e1) is tables
    _row(caller, "chr1", het=0.02)
    assert caller._joint_prior_tables(e1) is not tables


def test_the_table_is_built_in_its_span():
    from torch.profiler import ProfilerActivity, profile

    caller = _caller(TRIO_DENOVO)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        _row(caller, "chr1")
        t1 = time.time_ns()
    s = tracing.summary(t0, t1)
    assert s["spans"]["call.prior_table"]["n"] == 1
    assert s["counters"]["prior.table_cells"] == 11 ** 3


# --full-prior engine routes: S = 1, the contaminated pair, the plain pair,
# the trio loop and the generic loop
ROUTES = ["fp_single", "fp_pair_swapped_l2fc", "fp_l2fc", "fp_trio", "fp_s4"]


def _route_inputs(engine, seed):
    inputs = list(tbu.engine_inputs(engine, n_loci=6, depth=16, seed=seed))
    rng = np.random.default_rng(seed)
    G = tuple(len(v) for v in engine.values_s)
    tables = np.log(rng.uniform(0.05, 1.0, (3,) + G)).astype(np.float32)
    idx = rng.integers(0, 3, 6)
    idx[:3] = [2, 0, 1]
    return inputs, tables, idx


@pytest.mark.parametrize("route", ROUTES)
def test_rows_of_tables_equal_a_table_a_locus(route, monkeypatch):
    engine = CASES[route][0](_mods("torch"))
    inputs, tables, idx = _route_inputs(engine, ROUTES.index(route))
    per_locus = (tables[idx], np.arange(len(idx)))  # one table a locus
    want = engine.run(*inputs, ln_prior_joint=per_locus[0], ln_prior_idx=per_locus[1])
    got = engine.run(*inputs, ln_prior_joint=engine.upload_prior_tables(tables),
                     ln_prior_idx=idx)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if route == "fp_trio":
        # the trio loop over chunks of one and of four loci, in both
        # forms: the same bits
        for slab in (1, 4 * 8 * engine.n_branches * 11 * 11 * 4):
            monkeypatch.setattr(posterior, "_FULL_PRIOR_SLAB_BYTES", slab)
            for pj, rows in ((tables, idx), per_locus):
                chunked = engine.run(*inputs, ln_prior_joint=pj, ln_prior_idx=rows)
                for k in want:
                    np.testing.assert_array_equal(chunked[k], want[k], err_msg=k)


def test_tables_without_rows_are_refused():
    """--full-prior tables come with each locus's row: without the index
    the engine refuses them rather than guess one table a locus."""
    engine = CASES["fp_trio"][0](_mods("torch"))
    inputs, tables, _ = _route_inputs(engine, 0)
    with pytest.raises(ValueError, match="ln_prior_idx"):
        engine.run(*inputs, ln_prior_joint=tables)


def test_the_pass_counts_its_work():
    """Traced, the full-prior pass counts its steps, the joint cells every
    branch weighs (the product of each sample's finite weights, over active
    combinations and open branches), its bytes and its stream time."""
    from torch.profiler import ProfilerActivity, profile

    engine = CASES["fp_trio"][0](_mods("torch"))
    inputs, tables, idx = _route_inputs(engine, 5)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        engine.run(*inputs, ln_prior_joint=tables, ln_prior_idx=idx)
        t1 = time.time_ns()
    c = tracing.summary(t0, t1)["counters"]
    assert c["engine.full_prior_steps"] == len(engine.values_s[0])
    assert c["engine.full_prior_stream_ns"] > 0
    combo_active, gates = inputs[5], inputs[6]
    L, NB = gates.shape
    G = [len(v) for v in engine.values_s]
    assert 0 < c["engine.full_prior_cells"] <= L * combo_active.shape[1] * NB * math.prod(G)
    assert c["engine.full_prior_bytes"] >= 4 * tables.size
