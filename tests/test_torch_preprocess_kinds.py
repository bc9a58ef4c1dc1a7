"""The port's preprocess against the JAX package on every candidate kind.

The all-kinds world (``bench_utils.synth_preprocess_world`` with ``kinds``,
``ratchet`` and ``methylation`` on: TINY_WORLD's coverage and reads on a 40 kb
contig, which the SV zones need) holds, beside the indels and SNVs, MNVs,
replacements, ``<*>`` records, inversions, tandem duplications, an
inversion written as a BND group (MATEID, EVENT) and ``<METH>`` candidates
with 5mC MM / ML tags on the reads, each kind planted and as decoys; and
what moves the alignment-property maxima during the tumor's preprocess
(long somatic indels in the second half, large soft clips).

Its tumor and normal go through the JAX ``preprocess`` on its kernel path
(the Pallas K2 in interpret mode, the native forward off, as
tests/test_torch_preprocess.py runs it) and through the port's
``preprocess(..., device="cpu")``, at device chunk 1 and 64.  Each kind's
records are compared on their own (``compare_observation_files(...,
kinds=...)``), so that a difference names its kind; the tolerance is
``compare.py``'s for observations.  Then: the maxima really move, and chunk
64 then differs from chunk 1 at the same records in both packages; and the
port's ``--threads 2`` equals JAX's ``n_workers=2`` (each shard restarts the
maxima from the estimate).
"""

import multiprocessing

import numpy as np
import pytest
import torch

import varlociraptor_tpu.ops.pallas_pairhmm as jpp
from varlociraptor_tpu.calling.preprocess import PreprocessOptions as JaxOptions
from varlociraptor_tpu.calling.preprocess import preprocess as jax_preprocess
from varlociraptor_tpu.estimation.alignment_properties import AlignmentProperties, estimate
from varlociraptor_tpu.io.bam import BamReader
from varlociraptor_tpu.io.fasta import FastaBuffer
from varlociraptor_tpu_torch.bench_utils import KINDS_WORLD, OTHER_KINDS, synth_preprocess_world
from varlociraptor_tpu_torch.calling import preprocess as pp
from varlociraptor_tpu_torch.calling.variants import collect_variants
from varlociraptor_tpu_torch.compare import _read_observations, compare_observation_files
from varlociraptor_tpu_torch.convert import alignment_properties_from_jax
from varlociraptor_tpu_torch.io.vcf import open_variant_file

from test_torch_preprocess_parallel import _InProcessPool

KINDS = OTHER_KINDS + ("deletion", "insertion", "snv")
CHUNKS = (1, 64)
MAXIMA = ("max_del_cigar_len", "max_ins_cigar_len", "frac_max_softclip")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels of these small worlds on one thread: as fast alone,
    and a fraction of the CPU beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = synth_preprocess_world(tmp_path_factory.mktemp("kinds"), **KINDS_WORLD)
    w["props"] = estimate(BamReader(w["normal"]), reference=FastaBuffer(w["fasta"])).to_json()
    return w


def _kernel_path(mp):
    """The JAX package on its kernel path: Pallas K2 / K3 in interpret mode,
    no native forward; returns the list its calls are counted in."""
    mp.setenv("VLT_NATIVE_PAIRHMM", "0")
    mp.setenv("VLT_PALLAS_PAIRHMM", "1")
    # tests/test_hop_pairhmm.py turns the hop-state mode on when imported
    mp.setenv("VLT_HOP_STATES", "0")
    calls = []
    for kernel in ("exact", "general"):
        fn = getattr(jpp, f"pallas_{kernel}_forward")

        def counted(*args, _fn=fn, **kwargs):
            calls.append(1)
            return _fn(*args, **kwargs, interpret=True)

        mp.setattr(jpp, f"pallas_{kernel}_forward", counted)
    return calls


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Each package's observation files at each chunk, both samples, and the
    tumor's alignment properties after its run."""
    out = tmp_path_factory.mktemp("kinds_runs")
    files, after = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        jax_calls = _kernel_path(mp)
        for chunk in CHUNKS:
            for sample in ("tumor", "normal"):
                jax_props = AlignmentProperties.from_json(world["props"])
                port_props = alignment_properties_from_jax(
                    AlignmentProperties.from_json(world["props"]))
                ref, got = out / f"jax.{sample}.{chunk}.obs", out / f"torch.{sample}.{chunk}.obs"
                n_jax = jax_preprocess(
                    world["candidates"], world[sample], world["fasta"], str(ref),
                    sample_name=sample, alignment_properties=jax_props,
                    options=JaxOptions(log_mode="silent", device_chunk=chunk))
                n_port = pp.preprocess(
                    world["candidates"], world[sample], world["fasta"], str(got),
                    sample_name=sample, alignment_properties=port_props,
                    options=pp.PreprocessOptions(log_mode="silent", device_chunk=chunk),
                    device="cpu")
                assert n_jax == n_port == world["n_candidates"]
                files[sample, chunk] = (ref, got)
                after[sample, chunk] = {name: (getattr(jax_props, name), getattr(port_props, name))
                                        for name in MAXIMA}
    assert jax_calls
    return files, after


def _n_records(world, kind):
    return sum(info.kind == kind for rec in open_variant_file(world["candidates"])
               for info in collect_variants(rec))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_kind_matches_jax(world, runs, kind, chunk):
    files, _ = runs
    n = _n_records(world, kind)
    assert n >= 4
    for sample in ("tumor", "normal"):
        ref, got = files[sample, chunk]
        problems, info = compare_observation_files(ref, got, kinds={kind})
        assert not problems, (kind, sample, problems)
        assert info["records"] == n and info["reads"] > 0, (kind, sample, info)
        print(kind, sample, chunk, info)


def _differing_records(a_path, b_path):
    """Indices of the records whose observations differ between two files
    of the same candidates."""
    va, ca, ka, _ = _read_observations(a_path)
    vb, cb, kb, _ = _read_observations(b_path)
    assert len(va) == len(vb) and np.array_equal(ca, cb)
    off = np.concatenate([[0], np.cumsum(ca)])
    same = lambda x, y: np.array_equal(x, y, equal_nan=True)  # noqa: E731
    return [i for i in range(len(va))
            if not same(ka.f16[off[i]:off[i + 1]], kb.f16[off[i]:off[i + 1]])]


def test_ratchet_moves_the_maxima_and_splits_the_chunks(world, runs):
    """The tumor's run raises every maximum over the normal's estimate, in
    both packages alike; so the loci of a 64-locus chunk that precede the
    first long indel or large clip see maxima that per-locus runs do not,
    and chunk 64 differs from chunk 1 at the same records in both packages.
    The normal's run, which holds none of these reads, moves nothing."""
    files, after = runs
    start = AlignmentProperties.from_json(world["props"])
    for chunk in CHUNKS:
        for name in MAXIMA:
            jax_value, port_value = after["tumor", chunk][name]
            assert jax_value == port_value > getattr(start, name), (name, chunk)
            assert after["normal", chunk][name] == (getattr(start, name),) * 2
    differ = {}
    for side in (0, 1):
        differ[side] = _differing_records(files["tumor", 1][side], files["tumor", 64][side])
    assert differ[0] == differ[1] and differ[0], differ
    assert _differing_records(files["normal", 1][1], files["normal", 64][1]) == []
    print("records that differ between chunk 1 and 64:", differ[0])


def test_threads_match_jax_workers(world, tmp_path, monkeypatch):
    """The port's ``--threads 2`` (two spawned workers on the CPU) against
    the JAX package's ``n_workers=2`` (its workers run here, in this
    process, on the kernel path): the same shards, each restarting the
    maxima from the estimate, write the same observations."""
    for name, value in (("VLT_NATIVE_THREADS", "1"), ("JAX_PLATFORMS", "cpu")):
        monkeypatch.setenv(name, value)
    jax_calls = _kernel_path(monkeypatch)
    monkeypatch.setattr(pp, "worker_timeout_s", 240)
    reports = []
    monkeypatch.setattr(pp, "worker_hook", reports.extend)
    ref, got = tmp_path / "jax.obs", tmp_path / "torch.obs"
    n_port = pp.preprocess(world["candidates"], world["tumor"], world["fasta"], str(got),
                           sample_name="tumor",
                           alignment_properties=alignment_properties_from_jax(
                               AlignmentProperties.from_json(world["props"])),
                           options=pp.PreprocessOptions(log_mode="silent", n_workers=2),
                           device="cpu")
    jobs = []  # the JAX package's pool stands in after the port's workers ran
    monkeypatch.setattr(multiprocessing, "get_context", lambda method: _InProcessPool(jobs))
    n_jax = jax_preprocess(world["candidates"], world["tumor"], world["fasta"], str(ref),
                           sample_name="tumor",
                           alignment_properties=AlignmentProperties.from_json(world["props"]),
                           options=JaxOptions(log_mode="silent", n_workers=2))
    assert n_jax == n_port == world["n_candidates"]
    assert len(jobs) == len(reports) == 2
    assert [r["shard"] for r in reports] == [list(job) for job in jobs]
    problems, info = compare_observation_files(ref, got)
    assert not problems, problems
    assert info["records"] == world["n_candidates"]
    assert {r["device"] for r in reports} == {"cpu"}
    assert jax_calls  # the JAX shards ran its kernel path


def test_kinds_world_plants_what_it_says(world):
    """Every kind is in the candidates, planted and as decoys; reads across
    SV junctions carry soft clips, some align to the other strand; the
    reads carry MM / ML tags; the default world's digests stay those of
    tests/test_torch_preprocess.py (the options draw from their own
    generator)."""
    truth = world["truth"]["kinds"]
    for kind in ("mnv", "replacement", "inversion", "duplication"):
        assert truth[kind]["germline"] and truth[kind]["somatic"] and truth[kind]["decoy"]
    assert len(truth["breakend"]["germline"]) == 4 and len(truth["none"]["decoy"]) == 4
    assert len(truth["methylation"]["methylated"]) == len(truth["methylation"]["decoy"]) == 2
    assert len(truth["ratchet"]["somatic"]) == len(truth["ratchet"]["decoy"]) == 4
    assert all(p >= KINDS_WORLD["genome_len"] // 2 for p in truth["ratchet"]["somatic"])
    recs = list(BamReader(world["tumor"]).fetch("chr1", 0, KINDS_WORLD["genome_len"]))
    assert any(op == 4 and n >= 55 for r in recs for op, n in r.cigar)
    assert any(r.is_reverse and r.is_first_in_pair for r in recs)
    assert sum("MM" in r.tags for r in recs) > len(recs) // 2
    bnd = [r for r in open_variant_file(world["candidates"]) if r.info_get("SVTYPE") == "BND"]
    assert len({r.info_get("EVENT") for r in bnd}) == 1 and all(r.info_get("MATEID") for r in bnd)
