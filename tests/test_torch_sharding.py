"""The port's locus sharding (parallel/sharding.py), the sharded callers
and the collective FDR, against the port's own single-device runs and the
JAX package.

The port shards over ``["cpu"] * n``: a device may repeat in a LocusMesh, as
the JAX side's 8 virtual CPU devices (tests/conftest.py) let it run 8
shards here.

* ``run_sharded`` over 8 shards equals the port's ``engine.run`` (1e-5, as
  tests/test_sharding.py holds JAX) and agrees with JAX's ``run_sharded``
  over its 8 devices under ``compare.compare_outputs``, on a locus count that
  is a multiple of the shards and on one that is not (padding); 2 shards
  equal 8; the contamination 2-cycle engine sharded equals single;
* ``run_sharded_compact`` agrees with JAX's on the same dense compact panels;
* ``all_gather_rows`` in one process returns the ragged float64 rows bit for
  bit, as JAX's does;
* ``call_generic(mesh=...)``, columnar and ``VLT_LEGACY_CALL=1``: the VCF
  equals the port's no-mesh run of the same program byte for byte (the
  dense ``wire_mode = "panels"`` route, and the legacy ``engine.run``), the
  default wire route under ``compare_vcf_text``, and JAX's mesh run under
  ``compare_vcf_text``;
* ``control_fdr_sharded`` over 2 and 3 region shards keeps the records of
  the port's ``control_fdr`` on the concatenation and of JAX's
  ``control_fdr_sharded`` on the same shards, also with ``alpha=1.0`` and
  with a variant-type and length filter;
* without a card no mesh falls back to the CPU, and no backend to another.
"""

import math

import jax
import numpy as np
import pytest
import torch

from varlociraptor_tpu import bench_utils as jbu
from varlociraptor_tpu.calling import call as jcall
from varlociraptor_tpu.calling import fastcall as jfastcall
from varlociraptor_tpu.filtration import fdr as jfdr
from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario as j_tn_scenario
from varlociraptor_tpu.parallel import sharding as jsh
from varlociraptor_tpu_torch import bench_utils as tbu
from varlociraptor_tpu_torch.calling import fastcall
from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
from varlociraptor_tpu_torch.compare import compare_outputs, compare_vcf_text, vcf_record_keys
from varlociraptor_tpu_torch.filtration.fdr import control_fdr, control_fdr_sharded
from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
from varlociraptor_tpu_torch.ops.compact_obs import (
    CF_PA, CF_PDO, CF_PHA, CF_PHB, CF_PHV, CF_PM, CF_PME, CF_PR, CF_PSA,
    CU_FLAGS, CU_RO, CU_STRAND, N_CF, N_CU,
)
from varlociraptor_tpu_torch.parallel import sharding as sh

N_CALL_LOCI = 240


def cpu_mesh(n):
    return sh.locus_mesh(["cpu"] * n)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU engine on one thread: as fast at these sizes, and a
    fraction of the CPU beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    _, je = jbu.tumor_normal_engine(resolution=0.1)
    _, te = tbu.tumor_normal_engine(resolution=0.1, device="cpu")
    return je, te


def _check(ref, got, engine):
    # JAX's sharded runs return best_nonartifact as int32, its engine.run
    # (and every run of the port) as int64
    ref = {**ref, "best_nonartifact": ref["best_nonartifact"].astype(np.int64)}
    problems, _ = compare_outputs(ref, got, grid_values=engine.grid.values)
    assert not problems, problems[:5]


@pytest.mark.parametrize("n_loci", [16, 13])
def test_run_sharded_matches_single_and_jax(engines, n_loci):
    je, te = engines
    inputs = [a[:n_loci] for a in tbu.engine_inputs(te, n_loci=16, depth=8, seed=3)]
    single = te.run(*inputs)
    got = sh.run_sharded(te, cpu_mesh(8), *inputs)
    assert set(got) == set(single)
    np.testing.assert_allclose(got["posteriors"], single["posteriors"], rtol=1e-5, atol=1e-5)
    for k in single:
        assert got[k].shape == single[k].shape, k
    _check(single, got, te)
    ref = jsh.run_sharded(je, jsh.locus_mesh(jax.devices()), *inputs)
    assert set(ref) == set(got)
    _check(ref, got, te)


def test_shard_count_invariance(engines):
    _, te = engines
    inputs = tbu.engine_inputs(te, n_loci=16, depth=8, seed=3)
    out2 = sh.run_sharded(te, cpu_mesh(2), *inputs)
    out8 = sh.run_sharded(te, cpu_mesh(8), *inputs)
    np.testing.assert_allclose(out2["posteriors"], out8["posteriors"], rtol=1e-5, atol=1e-5)


def test_mutual_contamination_shard_invariance():
    """The contamination 2-cycle of tests/test_sharding.py, sharded against
    single (the engine's cycle loop on every shard)."""
    from varlociraptor_tpu_torch.grammar.compiler import compile_scenario_events
    from varlociraptor_tpu_torch.grammar.scenario import Scenario
    from varlociraptor_tpu_torch.ops.grid import AFGrid
    from varlociraptor_tpu_torch.ops.posterior import PosteriorEngine, SampleConfig

    sc = Scenario({
        "samples": {
            "tumor": {"universe": "[0.0,1.0]", "resolution": 0.1,
                      "contamination": {"by": "normal", "fraction": 0.2}},
            "normal": {"universe": "0.0 | 0.5 | 1.0",
                       "contamination": {"by": "tumor", "fraction": 0.05}},
        },
        "events": {"somatic": "tumor:]0.0,1.0] & normal:0.0",
                   "germline": "normal:0.5 | normal:1.0"},
    })
    events, pts = compile_scenario_events(sc, "chr1")
    samples = [
        SampleConfig("tumor", contaminated_by=1, contamination_fraction=0.2),
        SampleConfig("normal", contaminated_by=0, contamination_fraction=0.05),
    ]
    engine = PosteriorEngine(events, AFGrid.build(0.1, extra_points=pts), samples,
                             resolution=0.1, all_uniform_prior=True, device="cpu")
    assert engine._component_cycle(engine.components[0])
    inputs = tbu.engine_inputs(engine, n_loci=16, depth=8, seed=11)
    ref = engine.run(*inputs)
    out = sh.run_sharded(engine, cpu_mesh(8), *inputs)
    np.testing.assert_allclose(out["posteriors"], ref["posteriors"], rtol=1e-5, atol=1e-5)


def _compact_inputs(engine, L=13, D=8, Bc=3, seed=5):
    """Dense compact panels (run_sharded_compact's inputs) with
    synth_observation_files' feature distributions at random depths."""
    rng = np.random.default_rng(seed)
    S = engine.n_samples
    counts = rng.integers(0, D + 1, (L, S))
    mask = np.arange(D)[None, None, :] < counts[..., None]
    is_alt = rng.random((L, S, D)) < 0.3
    f16 = np.zeros((L, S, D, N_CF), np.float16)
    f16[..., CF_PM] = math.log(1 - 1e-5)
    f16[..., CF_PA] = np.where(is_alt, math.log(1 - 1e-4), math.log(1e-4))
    f16[..., CF_PR] = np.where(is_alt, math.log(1e-4), math.log(1 - 1e-4))
    f16[..., CF_PME] = math.log(0.5)
    f16[..., CF_PSA] = np.log(rng.uniform(0.5, 1.0, (L, S, D)))
    f16[..., CF_PDO] = -np.inf
    f16[..., CF_PHB] = math.log(0.01)
    f16[..., CF_PHA] = np.nan
    f16[..., CF_PHV] = np.nan
    f16[~mask] = 0
    u8 = np.zeros((L, S, D, N_CU), np.uint8)
    u8[..., CU_STRAND] = rng.integers(1, 4, (L, S, D))
    u8[..., CU_RO] = rng.integers(0, 3, (L, S, D))
    u8[..., CU_FLAGS] = rng.integers(0, 16, (L, S, D))
    u8[~mask] = 0
    hil = np.full((L, S, D), 127, np.int8)
    sm = np.zeros((L, Bc), np.int32)
    sm[:, 1:] = rng.integers(1, 9, (L, Bc - 1))
    sa = np.zeros((L, Bc), bool)
    sa[:, 0] = True
    sa[:, 1:] = rng.random((L, Bc - 1)) < 0.5
    return (f16, u8, hil, mask, sm, sa, np.ones((L, engine.n_branches), bool),
            np.full(L, math.log(0.5), np.float32),
            rng.uniform(0.3, 0.7, L).astype(np.float32), rng.random(L) < 0.2)


def test_run_sharded_compact_matches_jax(engines):
    je, te = engines
    inputs = _compact_inputs(te)
    n_art = np.random.default_rng(6).integers(1, 9, len(inputs[0])).astype(np.float32)
    got = sh.run_sharded_compact(te, cpu_mesh(8), *inputs, n_artifact_active=n_art)
    ref = jsh.run_sharded_compact(je, jsh.locus_mesh(jax.devices()), *inputs,
                                  n_artifact_active=n_art)
    assert set(ref) == set(got)
    _check(ref, got, te)
    # the single-device run of the same program, bit for bit
    single = te.run_compact(*inputs, n_artifact_active=n_art)
    for k in single:
        assert np.array_equal(single[k], got[k]), k


@pytest.mark.parametrize("ndim", [2, 1])
def test_all_gather_rows_one_process_bit_exact(ndim):
    """13 ragged rows over 8 shards, values whose float32 rounding differs:
    returned bit for bit and in order, as JAX's all_gather_rows returns them."""
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((13, 2)) / 3.0 + 1e-12
    if ndim == 1:
        rows = rows[:, 0]
    assert not np.array_equal(rows.astype(np.float32).astype(np.float64), rows)
    got = sh.all_gather_rows(rows, cpu_mesh(8))
    assert got.dtype == np.float64 and got.shape == rows.shape
    assert got.tobytes() == rows.tobytes()
    ref = jsh.all_gather_rows(rows, jsh.locus_mesh(jax.devices()))
    assert ref.tobytes() == got.tobytes()
    assert sh.all_gather_rows(rows[:0], cpu_mesh(8)).shape == rows[:0].shape


@pytest.fixture(scope="module")
def call_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_call")
    tumor, normal, _ = tbu.synth_observation_files(d / "obs", n_loci=N_CALL_LOCI, seed=4)
    return d, {"tumor": tumor, "normal": normal}


def _legacy(monkeypatch, legacy):
    if legacy:
        monkeypatch.setenv("VLT_LEGACY_CALL", "1")
    else:
        monkeypatch.delenv("VLT_LEGACY_CALL", raising=False)


@pytest.mark.parametrize("legacy", [False, True], ids=["columnar", "legacy"])
def test_call_generic_mesh(call_files, legacy, monkeypatch):
    d, obs = call_files
    _legacy(monkeypatch, legacy)
    tag = "legacy" if legacy else "columnar"
    mesh_vcf, same_vcf, wire_vcf, jax_vcf = (
        d / f"{tag}.{name}.vcf" for name in ("mesh", "same", "wire", "jax"))
    scenario = tumor_normal_scenario(0.75)
    n = call_generic(scenario, obs, str(mesh_vcf), CallOptions(), mesh=cpu_mesh(8),
                     device="cpu")
    assert n == N_CALL_LOCI
    # the same program on one device: the dense panels route (columnar) or
    # engine.run (legacy)
    monkeypatch.setattr(fastcall.ColumnarCaller, "wire_mode", "panels")
    call_generic(scenario, obs, str(same_vcf), CallOptions(), device="cpu")
    assert mesh_vcf.read_bytes() == same_vcf.read_bytes()
    monkeypatch.setattr(fastcall.ColumnarCaller, "wire_mode", "wire")
    call_generic(scenario, obs, str(wire_vcf), CallOptions(), device="cpu")
    mesh_text = mesh_vcf.read_text()
    problems, _ = compare_vcf_text(wire_vcf.read_text(), mesh_text)
    assert not problems, problems[:3]
    monkeypatch.setattr(jfastcall.ColumnarCaller, "wire_mode", "wire")
    jcall.call_generic(j_tn_scenario(0.75), obs, str(jax_vcf), jcall.CallOptions(),
                       mesh=jsh.locus_mesh(jax.devices()))
    problems, _ = compare_vcf_text(jax_vcf.read_text(), mesh_text)
    assert not problems, problems[:3]


def test_full_prior_window_stays_on_one_device(call_files, monkeypatch):
    """A --full-prior window carries ln_prior_joint: it runs the dense
    program on the caller's device, as in JAX, and equals the no-mesh run."""
    d, obs = call_files
    _legacy(monkeypatch, False)
    calls = []
    monkeypatch.setattr(sh, "run_sharded_compact", lambda *a, **k: calls.append(1))
    opts = CallOptions(full_prior=True, resolution=0.1)
    scenario = tumor_normal_scenario(0.75)
    a, b = d / "fp.mesh.vcf", d / "fp.same.vcf"
    call_generic(scenario, obs, str(a), opts, mesh=cpu_mesh(8), device="cpu")
    monkeypatch.setattr(fastcall.ColumnarCaller, "wire_mode", "panels")
    call_generic(scenario, obs, str(b), opts, device="cpu")
    assert not calls
    assert a.read_bytes() == b.read_bytes()


@pytest.fixture(scope="module")
def region_calls(call_files):
    """The columnar calls of call_files, with every third record rewritten
    into a deletion and every fifth into an insertion of 1-40 bases, so that
    the variant-type and length filters select a part."""
    d, obs = call_files
    calls = d / "regions.src.vcf"
    call_generic(tumor_normal_scenario(0.75), obs, str(calls), CallOptions(), device="cpu")
    head, recs = [], []
    for line in calls.read_text().splitlines(keepends=True):
        (head if line.startswith("#") else recs).append(line)
    for i, line in enumerate(recs):
        f = line.split("\t")
        k = 1 + (i * 7) % 40
        if i % 3 == 0:
            f[3] = f[3] + "ACGT" * 10
            f[3] = f[3][: 1 + k]
            f[4] = f[3][0]
        elif i % 5 == 0:
            f[4] = (f[3] + "TGCA" * 10)[: 1 + k]
        recs[i] = "\t".join(f)
    full = d / "regions.vcf"
    full.write_text("".join(head + recs))
    return d, full, head, recs


def _shards(d, head, recs, n):
    cuts = np.linspace(0, len(recs), n + 1).astype(int)
    paths = []
    for k in range(n):
        p = d / f"region{n}.{k}.vcf"
        p.write_text("".join(head + recs[cuts[k]:cuts[k + 1]]))
        paths.append(str(p))
    return paths


FDR_CASES = {
    "somatic": dict(events=["somatic_tumor"], alpha=0.05),
    "germline": dict(events=["germline_het", "germline_hom"], alpha=0.1),
    "alpha_one": dict(events=["somatic_tumor"], alpha=1.0),
    "deletions_1_30": dict(events=["somatic_tumor", "absent"], alpha=0.5,
                           vartype="deletion", min_len=1, max_len=30),
    "insertions": dict(events=["absent"], alpha=0.3, vartype="insertion"),
}


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("case", sorted(FDR_CASES))
def test_control_fdr_sharded(region_calls, n_shards, case):
    d, full, head, recs = region_calls
    kw = FDR_CASES[case]
    shards = _shards(d, head, recs, n_shards)
    single, sharded, jax_out = (d / f"{case}.{n_shards}.{n}.vcf"
                                for n in ("single", "sharded", "jax"))
    n_single = control_fdr(str(full), str(single), **kw)
    n_sharded = control_fdr_sharded(shards, str(sharded), mesh=cpu_mesh(n_shards), **kw)
    n_jax = jfdr.control_fdr_sharded(shards, str(jax_out),
                                     mesh=jsh.locus_mesh(jax.devices()[:n_shards]), **kw)
    kept = vcf_record_keys(sharded.read_text())
    assert n_sharded == n_single == n_jax == len(kept)
    assert kept == vcf_record_keys(single.read_text())
    assert sharded.read_text() == jax_out.read_text()
    if case == "alpha_one":
        assert n_sharded == len(recs)
    elif case.startswith("deletions"):
        assert 0 < n_sharded < len(recs) // 3
    else:
        assert 0 < n_sharded < len(recs)


def test_no_card_no_fallback(monkeypatch, tmp_path):
    """Without a card the default mesh raises and names the card, and so do
    the sharded FDR's default mesh and a torchrun-less distributed_mesh;
    NCCL refuses CPU shards and ranks that share a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for env in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(env, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sh.locus_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sh.distributed_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        sh.locus_mesh(["cuda:0"])
    vcf = tmp_path / "calls.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n"
                   '##INFO=<ID=PROB_SOMATIC,Number=A,Type=Float,Description="PHRED">\n'
                   "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        control_fdr_sharded([str(vcf)], str(tmp_path / "out.vcf"), ["somatic"], alpha=0.05)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sh.distributed_mesh()
    with pytest.raises(ValueError, match="gathers on the card"):
        sh.distributed_mesh(["cpu"], backend="nccl")
    with pytest.raises(ValueError, match="unsupported backend"):
        sh.distributed_mesh(["cpu"], backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one card"):
        sh.distributed_mesh()
    assert not torch.distributed.is_initialized()


def test_mesh_holds_one_engine_copy_per_device(engines):
    """An engine that lives on another device than a shard's is copied once
    per mesh, engine and device, with its tables moved; the engine stays."""
    import copy

    _, te = engines
    mesh = cpu_mesh(4)
    cpu = torch.device("cpu")
    assert mesh.engine_on(te, cpu) is te
    elsewhere = copy.copy(te)
    elsewhere.device = torch.device("cuda", 0)  # as if built on a card
    a = mesh.engine_on(elsewhere, cpu)
    assert a is not elsewhere and a.device == cpu
    assert mesh.engine_on(elsewhere, cpu) is a
    assert elsewhere.device == torch.device("cuda", 0)
    inputs = tbu.engine_inputs(te, n_loci=8, depth=8, seed=3)
    out = sh.run_sharded(elsewhere, mesh, *inputs)
    single = te.run(*inputs)
    for k in single:
        assert np.array_equal(out[k], single[k]), k
