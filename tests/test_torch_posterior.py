"""The port's posterior engine (ops/posterior.py) against the JAX package.

* the setup state (convert.engine_state_from_jax) equals the port's own
  __init__ state bit for bit, and from_state rebuilds the same engine, also
  for engines with l2fc masks and contamination cycles;
* run() on bench_utils.engine_inputs at two grid resolutions;
* run_wire() on the same uint8 input buffer, with and without the
  --full-prior ``pj`` section; and the port's run_wire() equal bit for bit
  to its run_compact() on the dense panels the buffer's rows gather into;
* the call stage's plug-in hooks, reference observation files and the
  device mesh against JAX.

Tolerances (varlociraptor_tpu_torch/compare.py): posteriors / marginal /
joint 1e-4 * max(1, |x|); af 1e-4 (the MAP parabola amplifies one-ulp float32
rounding of read sums of magnitude ~600), or anywhere on the reference's flat
density peak at low depth; densities_dphred +-1 with top-K
swaps only between points of equal quantised density; best_nonartifact,
map_slot, n_obs exact."""

import math

import numpy as np
import pytest

from varlociraptor_tpu import bench_utils as jbu
from varlociraptor_tpu_torch import bench_utils as tbu
from varlociraptor_tpu_torch.compare import compare_outputs
from varlociraptor_tpu_torch.convert import engine_state_from_jax
from varlociraptor_tpu_torch.ops.compact_obs import (
    CF_PA, CF_PDO, CF_PHA, CF_PHB, CF_PHV, CF_PM, CF_PME, CF_PR, CF_PSA,
    CU_FLAGS, CU_RO, CU_STRAND, N_CF, N_CU,
)
from varlociraptor_tpu_torch.ops.posterior import PosteriorEngine
from test_torch_engine_modes import CASES, _mods


def _engines(resolution):
    _, je = jbu.tumor_normal_engine(resolution=resolution)
    _, te = tbu.tumor_normal_engine(resolution=resolution, device="cpu")
    return je, te


def _assert_state_equal(a, b):
    assert a.keys() == b.keys(), set(a) ^ set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


# tumor-normal at two resolutions, and engines with l2fc masks (star,
# cyclic, chained over contaminated samples, a scenario with a swapped pair,
# four samples) and contamination cycles (tests/test_torch_engine_modes.py)
STATE_CASES = [0.1, 0.01, "star_l2fc", "cyclic_l2fc", "chained_l2fc_contaminated",
               "l2fc_scenario", "fp_s4_l2fc", "cycle3", "rho4", "cycle3_l2fc"]


@pytest.mark.parametrize("case", STATE_CASES, ids=str)
def test_engine_state_bit_for_bit(case):
    if isinstance(case, float):
        je, te = _engines(case)
    else:
        je, te = (CASES[case][0](_mods(pkg)) for pkg in ("jax", "torch"))
    state = engine_state_from_jax(je)
    _assert_state_equal(state, te.state())
    rebuilt = PosteriorEngine.from_state(state, device="cpu")
    _assert_state_equal(state, rebuilt.state())
    if isinstance(case, float):
        # U unique (nu, kappa) classes of the tumor's contaminated plane
        (si, _by, _f), = te.pairs
        assert len(te.pair_class[si][0]) == {0.1: 76, 0.01: 711}[case]
        return
    # the masks and the contamination graph survive the trip
    assert rebuilt.branch_lfc_masks.keys() == je.branch_lfc_masks.keys()
    for bi, lst in je.branch_lfc_masks.items():
        for (a, b, m), (a2, b2, m2) in zip(lst, rebuilt.branch_lfc_masks[bi], strict=True):
            assert (a, b) == (a2, b2) and a < b and np.array_equal(m, m2)
    assert rebuilt.singletons == je.singletons
    assert [rebuilt._component_cycle(c) for c in rebuilt.components] == [
        je._component_cycle(c) for c in je.components
    ]
    assert bool(je.branch_lfc_masks) == (case.find("l2fc") >= 0)


def _check(ref, got, engine):
    problems, info = compare_outputs(ref, got, grid_values=engine.grid.values)
    assert not problems, problems
    # listed, not failed: ties at the output's own resolution
    if info["topk_swaps"]:
        print("AFD top-K swaps between equal-density points:", info["topk_swaps"])
    if info["af_flat"]:
        print("MAP AF on a flat density peak:", info["af_flat"])


@pytest.mark.parametrize(
    "resolution,n_loci,depth", [(0.1, 64, 16), (0.01, 32, 16)]
)
def test_run_matches_jax(resolution, n_loci, depth):
    je, te = _engines(resolution)
    inputs = jbu.engine_inputs(je, n_loci=n_loci, depth=depth, seed=0)
    ref = je.run(*inputs)
    got = te.run(*inputs)
    assert set(ref) == set(got)
    _check(ref, got, te)
    # an engine rebuilt from the JAX engine's state gives the same answers
    fs = PosteriorEngine.from_state(engine_state_from_jax(je), device="cpu")
    again = fs.run(*inputs)
    for k in got:
        assert np.array_equal(got[k], again[k]), k


def _wire_arrays(engine, L=48, D=16, Bc=3, seed=3, full_prior=False):
    """The named sections of a run_wire input buffer, its dimensions
    (Np, L, D, Bc) and the --full-prior tables (three, each locus's row in
    the ``pj`` section) or None: flat observations of random depth per
    (locus, sample) with synth_observation_files' feature distributions."""
    rng = np.random.default_rng(seed)
    S = engine.n_samples
    counts = rng.integers(0, D + 4, (L, S)).astype(np.int32)  # some > D
    N = int(counts.sum())
    Np = N + 37
    is_alt = rng.random(Np) < 0.3
    f16 = np.zeros((Np, N_CF), np.float16)
    f16[:, CF_PM] = math.log(1 - 1e-5)
    f16[:, CF_PA] = np.where(is_alt, math.log(1 - 1e-4), math.log(1e-4))
    f16[:, CF_PR] = np.where(is_alt, math.log(1e-4), math.log(1 - 1e-4))
    f16[:, CF_PME] = math.log(0.5)
    f16[:, CF_PSA] = np.log(rng.uniform(0.5, 1.0, Np))
    f16[:, CF_PDO] = -np.inf
    f16[:, CF_PHB] = math.log(0.01)
    f16[:, CF_PHA] = np.nan
    f16[:, CF_PHV] = np.nan
    u8 = np.zeros((Np, N_CU), np.uint8)
    u8[:, CU_STRAND] = rng.integers(1, 4, Np)
    u8[:, CU_RO] = rng.integers(0, 3, Np)
    u8[:, CU_FLAGS] = rng.integers(0, 16, Np)
    hil = np.full(Np, 127, np.int8)
    sm = np.zeros((L, Bc), np.int32)
    sm[:, 1:] = rng.integers(1, 9, (L, Bc - 1))
    sa = np.zeros((L, Bc), np.uint8)
    sa[:, 0] = 1
    sa[:, 1:] = rng.random((L, Bc - 1)) < 0.5
    arrays = {
        "f16f": f16, "u8f": u8, "hilf": hil, "counts": counts, "sm": sm,
        "sa": sa, "bg": np.ones((L, engine.n_branches), np.uint8),
        "pa": np.full(L, math.log(0.5), np.float32),
        "fr": rng.uniform(0.3, 0.7, L).astype(np.float32),
        "hal": (rng.random(L) < 0.2).astype(np.uint8),
        "n_art": rng.integers(1, 9, L).astype(np.float32),
    }
    tables = None
    if full_prior:
        shape = tuple(len(v) for v in engine.values_s)
        tables = np.log(rng.uniform(0.05, 1.0, (3,) + shape)).astype(np.float32)
        arrays["pj"] = rng.integers(0, 3, L).astype(np.int32)
    return arrays, (Np, L, D, Bc), tables


def _wire_inputs(engine, **kw):
    """A run_wire input buffer (the port's ``pack_wire``, the JAX package's
    ``pack_in_wire``, whose ``pj`` section carries each locus's table
    itself), its dimensions and the --full-prior tables."""
    arrays, dims, tables = _wire_arrays(engine, **kw)
    if isinstance(engine, PosteriorEngine):
        return engine.pack_wire(arrays, *dims, tables is not None), dims, tables
    pj_shape = None
    if tables is not None:
        arrays = dict(arrays, pj=tables[arrays["pj"]])
        pj_shape = tables.shape[1:]
    return engine.pack_in_wire(engine._in_wire_spec(*dims, pj_shape), arrays), dims, tables


def test_run_wire_matches_jax():
    je, te = _engines(0.01)
    buf, dims, _ = _wire_inputs(je)
    # both packages lay the buffer out identically
    tbuf, _, _ = _wire_inputs(te)
    assert np.array_equal(buf, tbuf)
    ref = je.run_wire(buf, *dims)
    got = te.run_wire(buf, *dims)
    assert set(ref) == set(got)
    _check(ref, got, te)
    # fetch=False returns a pending handle that any caller may finish
    pending = te.run_wire(buf, *dims, fetch=False)
    again = te.fetch_run(pending)
    for k in got:
        assert np.array_equal(got[k], again[k]), k


def test_run_wire_full_prior_matches_jax():
    """The --full-prior joint prior: the port's wire carries each locus's
    row of tables that lie on the device, the JAX package's carries each
    locus's table itself (the index expanded); both give the same
    outputs."""
    je, te = _engines(0.1)
    buf, dims, tables = _wire_inputs(je, full_prior=True)
    tbuf, _, ttables = _wire_inputs(te, full_prior=True)
    assert np.array_equal(tables, ttables)
    pj_shape = tuple(len(v) for v in te.values_s)
    ref = je.run_wire(buf, *dims, pj_shape=pj_shape)
    got = te.run_wire(tbuf, *dims, prior_tables=te.upload_prior_tables(tables))
    _check(ref, got, te)
    # the joint prior moves the posteriors: the section is read
    plain = te.run_wire(_wire_inputs(te)[0], *dims)
    assert not np.allclose(plain["posteriors"], got["posteriors"])


@pytest.mark.parametrize("full_prior", [False, True], ids=["plain", "joint_prior"])
def test_run_wire_equals_run_compact_on_its_panels(full_prior):
    """run_wire equals run_compact bit for bit on the dense panels its rows
    gather into: (locus, sample) takes the first min(count, D) rows of its
    segment, the rest of its D slots are empty (zero features, no
    homopolymer information); with the joint prior section, run_compact
    gets the same table."""
    from varlociraptor_tpu_torch.evidence.observation import HOMOPOLYMER_NONE

    _, te = tbu.tumor_normal_engine(resolution=0.1, device="cpu")
    arrays, (Np, L, D, Bc), tables = _wire_arrays(te, full_prior=full_prior)
    counts = np.minimum(arrays["counts"].astype(np.int64), D)
    start = np.cumsum(counts).reshape(counts.shape) - counts
    slot = np.arange(D)
    mask = slot < counts[:, :, None]
    src = (start[:, :, None] + slot)[mask]
    f16 = np.zeros((L, te.n_samples, D, N_CF), np.float16)
    u8 = np.zeros((L, te.n_samples, D, N_CU), np.uint8)
    hil = np.full((L, te.n_samples, D), HOMOPOLYMER_NONE, np.int8)
    f16[mask], u8[mask], hil[mask] = (arrays[k][src] for k in ("f16f", "u8f", "hilf"))
    got = te.run_wire(te.pack_wire(arrays, Np, L, D, Bc, full_prior), Np, L, D, Bc,
                      prior_tables=tables)
    ref = te.run_compact(
        f16, u8, hil, mask, arrays["sm"], arrays["sa"] != 0, arrays["bg"] != 0,
        arrays["pa"], arrays["fr"], arrays["hal"] != 0,
        ln_prior_joint=tables, ln_prior_idx=arrays.get("pj"),
        n_artifact_active=arrays["n_art"])
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _ref_obs_file(path):
    """A reference observation VCF (the v15 format) with one SNV."""
    from varlociraptor_tpu_torch.calling.ref_obs import ReferenceObservationWriter
    from varlociraptor_tpu_torch.calling.variants import VariantInfo
    from varlociraptor_tpu_torch.evidence.observation import (
        Pileup, ReadObservation, set_prob_mapping, set_prob_overlap,
    )

    obs = ReadObservation()
    set_prob_mapping(obs, -1e-9)
    obs.prob_alt, obs.prob_ref = -1e-9, math.log(1e-8)
    obs.prob_missed_allele = math.log(0.5)
    obs.prob_sample_alt = 0.0
    set_prob_overlap(obs, -math.inf)
    with ReferenceObservationWriter(str(path), "sample") as w:
        w.write_record(
            VariantInfo(kind="snv", chrom="chr1", pos=100, ref_allele="A",
                        alt_allele="T"),
            Pileup(read_observations=[obs]),
        )
    return str(path)


@pytest.mark.parametrize(
    "mode", ["call_processor", "candidate_filter", "reference_observations", "mesh"]
)
def test_modes_outside_the_slice_raise(mode, tmp_path):
    """The call stage's plug-in hooks, reference observation files (the
    legacy per-WorkItem caller and the record-by-record reader) and the
    device mesh (8 shards on each side) run and agree with JAX on a one-SNV
    reference observation VCF.  The test's name dates from when the mesh was
    refused."""
    import os

    import jax

    from varlociraptor_tpu.calling import call as jcall
    from varlociraptor_tpu.parallel.sharding import locus_mesh as j_locus_mesh
    from varlociraptor_tpu_torch.parallel.sharding import locus_mesh
    from varlociraptor_tpu.grammar.scenario import Scenario as JScenario
    from varlociraptor_tpu_torch.calling.call import call_generic
    from varlociraptor_tpu_torch.compare import compare_vcf_text
    from varlociraptor_tpu_torch.grammar.scenario import Scenario

    doc = {
        "samples": {"sample": {"universe": "[0.0,1.0]", "ploidy": 2}},
        "events": {"present": "sample:]0.0,1.0]"},
    }
    obs = {"sample": _ref_obs_file(tmp_path / "sample.obs.vcf")}
    seen = {"jax": [], "torch": []}

    def hooks(side):
        if mode == "call_processor":
            return {"call_processor": seen[side].append}
        if mode == "candidate_filter":
            return {"candidate_filter": lambda item: seen[side].append(
                (item.index, item.flags, item.snv)) or True}
        if mode == "mesh":
            return {"mesh": j_locus_mesh(jax.devices()) if side == "jax"
                    else locus_mesh(["cpu"] * 8)}
        return {}

    assert "VLT_LEGACY_CALL" not in os.environ
    ref, got = tmp_path / "jax.vcf", tmp_path / "torch.vcf"
    assert jcall.call_generic(JScenario(doc), obs, str(ref), **hooks("jax")) == 1
    assert call_generic(Scenario(doc), obs, str(got), device="cpu", **hooks("torch")) == 1
    problems, _ = compare_vcf_text(ref.read_text(), got.read_text())
    assert not problems, problems
    assert len(seen["torch"]) == len(seen["jax"]) == (
        1 if mode in ("call_processor", "candidate_filter") else 0)
    if mode == "candidate_filter":
        assert seen["torch"] == seen["jax"] == [(0, seen["jax"][0][1], ("A", "T"))]
    if mode == "call_processor":
        a, b = seen["jax"][0], seen["torch"][0]
        assert b["hints"] == a["hints"]
        assert b["event_probs"].keys() == a["event_probs"].keys()
        for k, x in a["event_probs"].items():
            y = b["event_probs"][k]
            assert x == y or abs(y - x) <= 1e-4 * max(1.0, abs(x)), (k, x, y)
        assert abs(b["sample_infos"][0]["af"] - a["sample_infos"][0]["af"]) <= 1e-4
