"""The port's preprocess (BAM -> observations) against the JAX package.

A tiny seeded world (``bench_utils.synth_preprocess_world``: 20 kb, 6x
paired-end, 16 germline + 12 somatic + 12 decoy indel candidates and 10 SNV
candidates) goes through the JAX ``preprocess`` on its kernel path (the
Pallas K2 / K3 in interpret mode, as tests/test_pallas_pairhmm.py runs them;
the native host forward switched off) and through the port's
``preprocess(..., device="cpu")`` (the plain K2 / K3 / K4), once with the
gap model ``estimate()`` gives on this world (zero extension: K2), once with
finite ONT-like extensions (K3), and once in ``--pairhmm-mode homopolymer``
(K4) with fixed hop params of ln 0.05 for every base (the 20 kb world holds
too few homopolymer indels for the estimate's MLE).

Tolerance (``compare.compare_observation_files``): the same records and read
counts, every field the pair-HMM does not touch identical, and prob_alt,
prob_ref, prob_missed_allele within 5e-4 * max(1, |x|) plus one float16
step of the file, or both below -30.  Measured on this world: every value
above -30 is identical (largest relative error 0.0); below -30, 62 read
values of the K2 runs and 4 of the K3 runs differ, by up to whole units
(XLA flushes float32 denormals, torch keeps them; see
test_torch_pairhmm.py::test_denormals_explain_the_difference_from_xla).

The tumor also goes through both packages with ``--pairhmm-mode fast``,
``--region`` and ``--report-fragment-ids`` (same tolerance), and through the
port alone with 16 loci per pair-HMM call against one (identical values),
as the JAX package's own chunking tests hold it; a two-contig BAM holds
chunked fragment ids to per-locus ones.

Then the port's CLI runs estimate -> preprocess (tumor, normal) -> call ->
filter-calls on the same world with ``--device cpu``, in the default and in
the homopolymer mode.  Last, the world generator: the default world is the
one earlier versions wrote, byte for byte, and the opt-in homopolymer
profile plants what it says.
"""

import gzip
import hashlib
import json
import math

import numpy as np
import pytest

import varlociraptor_tpu.ops.pallas_pairhmm as jpp
from varlociraptor_tpu.calling.preprocess import PreprocessOptions as JaxOptions
from varlociraptor_tpu.calling.preprocess import preprocess as jax_preprocess
from varlociraptor_tpu.estimation.alignment_properties import (
    AlignmentProperties,
    GapParams,
    HopParams,
    estimate,
)
from varlociraptor_tpu.io.bam import BamReader
from varlociraptor_tpu.io.fasta import FastaBuffer
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.bench_utils import _homopolymer_runs, synth_preprocess_world
from varlociraptor_tpu_torch.calling.preprocess import PreprocessOptions, preprocess
from varlociraptor_tpu_torch.compare import compare_observation_files, vcf_record_keys
from varlociraptor_tpu_torch.convert import alignment_properties_from_jax
from varlociraptor_tpu_torch.ops import pairhmm_column as phc

ONT_GAPS = GapParams(math.log(5.1e-3), math.log(4.2e-3), math.log(0.35), math.log(0.42))
HOP_005 = HopParams(*([[math.log(0.05)] * 4] * 4))
TINY_WORLD = dict(seed=1, genome_len=20_000, coverage=6.0, n_germline=16, n_somatic=12,
                  n_decoy=12, n_snv=10)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return synth_preprocess_world(tmp_path_factory.mktemp("world"), **TINY_WORLD)


@pytest.fixture(autouse=True)
def _positional_gap_route(monkeypatch):
    """The homopolymer route these tests hold is the positional-gap one:
    tests/test_hop_pairhmm.py sets VLT_HOP_STATES=1 when it is imported
    (every xdist worker imports it), and the port's dispatcher reads it."""
    monkeypatch.setenv("VLT_HOP_STATES", "0")


def _props(world, model):
    props = estimate(BamReader(world["normal"]), reference=FastaBuffer(world["fasta"]))
    if model == "ont":
        props.gap_params = ONT_GAPS
    if model == "homopolymer":
        props.hop_params = HOP_005
    return props.to_json()


def _counting(monkeypatch, module, name, **kw):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize(
    "model,kernel",
    [("estimated", "exact"), ("ont", "general"), ("homopolymer", "positional")],
)
def test_preprocess_matches_jax(world, tmp_path, monkeypatch, model, kernel):
    props = _props(world, model)
    # the estimate on this small world keeps zero extension (K2)
    ext = json.loads(props)["gap_params"]["prob_insertion_extend_artifact"]
    assert (ext is None) == (kernel != "general")
    mode = "homopolymer" if kernel == "positional" else "exact"
    # the JAX package on its kernel path: Pallas K2 / K3 / K4 in interpret mode
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "0")
    monkeypatch.setenv("VLT_PALLAS_PAIRHMM", "1")
    # tests/test_hop_pairhmm.py turns the hop-state mode on when imported
    monkeypatch.setenv("VLT_HOP_STATES", "0")
    jax_calls = _counting(monkeypatch, jpp, f"pallas_{kernel}_forward", interpret=True)
    port_calls = _counting(monkeypatch, phc, f"{kernel}_forward")
    for sample in ("tumor", "normal"):
        ref, got = tmp_path / f"jax.{sample}.obs", tmp_path / f"torch.{sample}.obs"
        n_jax = jax_preprocess(
            world["candidates"], world[sample], world["fasta"], str(ref),
            sample_name=sample, alignment_properties=AlignmentProperties.from_json(props),
            options=JaxOptions(log_mode="silent", pairhmm_mode=mode),
        )
        n_port = preprocess(
            world["candidates"], world[sample], world["fasta"], str(got),
            sample_name=sample,
            alignment_properties=alignment_properties_from_jax(AlignmentProperties.from_json(props)),
            options=PreprocessOptions(log_mode="silent", pairhmm_mode=mode), device="cpu",
        )
        assert n_jax == n_port == world["n_candidates"]
        problems, info = compare_observation_files(ref, got)
        assert not problems, problems
        assert info["records"] == world["n_candidates"] and info["reads"] > 100
        print(sample, model, info)
    # both ran their column kernels (per locus on the CPU), not another path
    assert jax_calls and port_calls


@pytest.mark.parametrize("model", ["estimated", "ont", "homopolymer"])
def test_alignment_properties_carried_from_jax(world, model):
    """A JAX ``AlignmentProperties`` becomes the port's own class with the
    same values (the port never takes the JAX package's classes)."""
    from varlociraptor_tpu_torch.estimation import alignment_properties as port_ap

    jax_props = AlignmentProperties.from_json(_props(world, model))
    props = alignment_properties_from_jax(jax_props)
    assert type(props) is port_ap.AlignmentProperties
    assert type(props.gap_params) is port_ap.GapParams
    assert type(props.hop_params) is port_ap.HopParams
    assert props.to_json() == jax_props.to_json()
    assert vars(props.gap_params) == vars(jax_props.gap_params)
    assert vars(props.hop_params) == vars(jax_props.hop_params)


@pytest.mark.parametrize("mode", ["exact", "homopolymer"])
def test_cli_pipeline_on_cpu(world, tmp_path, capsys, monkeypatch, mode):
    props = tmp_path / "props.json"
    assert cli.run(["estimate", "alignment-properties", world["fasta"], "--bam",
                    world["normal"]]) == 0
    props.write_text(capsys.readouterr().out)
    assert AlignmentProperties.from_json(props.read_text()).max_read_len == 100
    calls = _counting(monkeypatch, phc, "positional_forward")
    obs = {}
    for sample in ("tumor", "normal"):
        obs[sample] = str(tmp_path / f"{sample}.obs")
        assert cli.run(["preprocess", "variants", world["fasta"], "--bam", world[sample],
                        "--candidates", world["candidates"], "--output", obs[sample],
                        "--sample-name", sample, "--alignment-properties", str(props),
                        "--pairhmm-mode", mode, "--device", "cpu"]) == 0
    # homopolymer mode runs K4 (the estimate's hop params are -inf on this
    # world: base rates everywhere), the default mode never does
    assert bool(calls) == (mode == "homopolymer")
    calls, kept = tmp_path / "calls.vcf", tmp_path / "kept.vcf"
    assert cli.run(["call", "variants", "tumor-normal", "--tumor", obs["tumor"],
                    "--normal", obs["normal"], "--purity", "0.75", "--device", "cpu",
                    "--output", str(calls)]) == 0
    assert len(vcf_record_keys(calls.read_text())) == world["n_candidates"]
    assert cli.run(["filter-calls", "control-fdr", str(calls), "--events",
                    "somatic_tumor", "--fdr", "0.05", "--output", str(kept)]) == 0
    assert kept.exists()


@pytest.mark.parametrize("option", [
    {"pairhmm_mode": "fast"},
    {"region": "chr1:2001-12000"},
    {"report_fragment_ids": True},
], ids=["fast", "region", "fragment_ids"])
def test_preprocess_options_match_jax(world, tmp_path, monkeypatch, option):
    """The tumor with ``--pairhmm-mode fast`` (the realigner scores the
    edit-distance path on the host: no pair-HMM kernel), ``--region`` and
    ``--report-fragment-ids`` (the fragment-id column compared too), each
    through the JAX package on its kernel path and through the port."""
    props = _props(world, "estimated")
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "0")
    monkeypatch.setenv("VLT_PALLAS_PAIRHMM", "1")
    monkeypatch.setenv("VLT_HOP_STATES", "0")
    jax_calls = _counting(monkeypatch, jpp, "pallas_exact_forward", interpret=True)
    port_calls = _counting(monkeypatch, phc, "exact_forward")
    ref, got = tmp_path / "jax.obs", tmp_path / "torch.obs"
    n_jax = jax_preprocess(
        world["candidates"], world["tumor"], world["fasta"], str(ref), sample_name="tumor",
        alignment_properties=AlignmentProperties.from_json(props),
        options=JaxOptions(log_mode="silent", **option),
    )
    n_port = preprocess(
        world["candidates"], world["tumor"], world["fasta"], str(got), sample_name="tumor",
        alignment_properties=alignment_properties_from_jax(AlignmentProperties.from_json(props)),
        options=PreprocessOptions(log_mode="silent", **option), device="cpu",
    )
    problems, info = compare_observation_files(ref, got)
    assert not problems, problems
    assert n_jax == n_port == info["records"] > 0 and info["reads"] > 40
    if "region" in option:
        assert n_port < world["n_candidates"]
    else:
        assert n_port == world["n_candidates"]
    # fast mode never runs the forward; the others run the column kernel
    assert bool(jax_calls) == bool(port_calls) == (option.get("pairhmm_mode") != "fast")
    print(option, info)


@pytest.mark.parametrize("model", ["estimated", "ont"])
def test_chunked_matches_serial(world, tmp_path, model):
    """Port analog of tests/test_preprocess_parallel.py::test_chunked_matches_serial:
    the pair-HMM forwards of 16 loci in one call write what one locus per
    call writes (K2 with the estimate, K3 with ONT-like extensions)."""
    props = alignment_properties_from_jax(AlignmentProperties.from_json(_props(world, model)))
    out = {}
    for chunk in (1, 16):
        out[chunk] = tmp_path / f"chunk{chunk}.obs"
        preprocess(world["candidates"], world["tumor"], world["fasta"], str(out[chunk]),
                   alignment_properties=props, device="cpu",
                   options=PreprocessOptions(log_mode="silent", device_chunk=chunk))
    problems, info = compare_observation_files(out[1], out[16])
    assert not problems, problems
    assert info["records"] == world["n_candidates"]
    assert all(v == 0.0 for v in info["max_rel"].values()), info


def test_fragment_ids_chunked_across_contigs(tmp_path):
    """Port analog of tests/test_preprocess_parallel.py::test_fragment_ids_chunked_across_contigs:
    a chunk that spans a contig boundary is flushed BEFORE the per-contig
    fragment-id map resets (fragment_id_factory.rs:6-25), so chunked ids
    equal per-locus ids."""
    from varlociraptor_tpu_torch.calling.ref_obs import open_observations
    from varlociraptor_tpu_torch.io.bam import BamRecord, BamWriter

    rng = np.random.default_rng(3)
    ref_len = 3000
    seqs = {c: rng.choice(np.frombuffer(b"ACGT", np.uint8), ref_len) for c in ("c1", "c2")}
    fa = tmp_path / "ref.fa"
    fa.write_text("".join(f">{c}\n{bytes(s).decode()}\n" for c, s in seqs.items()))
    bam = tmp_path / "two.bam"
    w = BamWriter(bam, ["c1", "c2"], [ref_len, ref_len])
    qn = 0
    for tid, c in enumerate(("c1", "c2")):
        for pos in range(800, 1400, 25):
            qn += 1
            w.write_record(BamRecord(
                qname=f"r{qn}", flag=0, tid=tid, pos=pos, mapq=60, cigar=[(0, 100)],
                mtid=-1, mpos=-1, tlen=0, seq=np.ascontiguousarray(seqs[c][pos:pos + 100]),
                qual=np.full(100, 30, np.uint8), tags={},
            ))
    w.close()
    cand = tmp_path / "cand.vcf"
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=c1>", "##contig=<ID=c2>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for c in ("c1", "c2"):
        for pos in (1000, 1050, 1100, 1150, 1200):
            refb = chr(seqs[c][pos - 1])
            lines.append(f"{c}\t{pos}\t.\t{refb}\t{'A' if refb != 'A' else 'G'}\t.\t.\t.")
    cand.write_text("\n".join(lines) + "\n")

    def run(chunk):
        out = tmp_path / f"obs-{chunk}.jsonl"
        preprocess(cand, bam, fa, out, sample_name="s", device="cpu",
                   options=PreprocessOptions(log_mode="silent", report_fragment_ids=True,
                                             device_chunk=chunk, omit_insert_size=True))
        reader = open_observations(out)
        ids = [(v.chrom, v.pos, tuple(o.fragment_id for o in p.read_observations))
               for v, p in reader]
        reader.close()
        return ids

    serial = run(1)
    assert run(4) == serial  # the chunk of 4 spans the c1/c2 boundary
    assert len(serial) == 10 and any(ids for _c, _p, ids in serial)


def _digests(w):
    h = lambda b: hashlib.sha256(b).hexdigest()[:16]  # noqa: E731
    out = {k: h(open(w[k], "rb").read()) for k in ("fasta", "candidates")}
    for k in ("tumor", "normal"):  # BGZF inflated: independent of zlib's deflate
        out[k] = h(gzip.decompress(open(w[k], "rb").read()))
    return out


def test_default_world_is_unchanged(world):
    """The default world is the one earlier versions of the generator wrote
    (digests of the files, the BAMs inflated), so the homopolymer profile
    leaves the worlds of the tests and of chip_smoke.py's phase (d) alone."""
    assert _digests(world) == {
        "fasta": "3f2cf8131eb6b118", "candidates": "04585b2515d71438",
        "tumor": "02b14c79e5dd5b8c", "normal": "5a2195d131656b92",
    }
    assert "in_run" not in world["truth"]


def test_homopolymer_world(world, tmp_path):
    """The opt-in profile: runs of 5-12 bases about one per 150 bases, half
    of the germline / somatic / decoy indels as 1-3 base run-length changes
    at a run's start, and reads that slip in runs (1-base I / D ops)."""
    hp = synth_preprocess_world(tmp_path / "hp", homopolymer=True, **TINY_WORLD)
    ref = bytes(FastaBuffer(hp["fasta"]).seq("chr1"))
    plain = bytes(FastaBuffer(world["fasta"]).seq("chr1"))
    assert len(ref) == len(plain) and ref != plain
    starts, lens = _homopolymer_runs(np.frombuffer(ref, np.uint8))
    assert len(ref) / 150 <= len(starts) <= len(ref) / 90
    in_run = hp["truth"]["in_run"]
    assert len(in_run) == (16 + 12 + 12) // 2
    roles = {k: set(hp["truth"][k].tolist()) for k in ("germline", "somatic", "decoy")}
    for k, n in (("germline", 8), ("somatic", 6), ("decoy", 6)):
        assert len(roles[k] & set(in_run.tolist())) == n
    records = {int(line.split("\t")[1]) - 1: line.split("\t")[3:5]
               for line in open(hp["candidates"]) if not line.startswith("#")}
    for p in in_run.tolist():
        ref_allele, alt = records[p]
        change = (alt[1:] if len(alt) > len(ref_allele) else ref_allele[1:])
        run = ref[p + 1 : p + 1 + 5]
        assert 1 <= len(change) <= 3 and set(change) == {chr(run[0])}
        assert len(set(run)) == 1 and ref[p] != run[0]
    slips = sum(1 for rec in BamReader(hp["normal"]).fetch("chr1", 0, len(ref))
                for op, n in rec.cigar if op in (1, 2) and n == 1)
    plain_ops = sum(1 for rec in BamReader(world["normal"]).fetch("chr1", 0, len(ref))
                    for op, n in rec.cigar if op in (1, 2) and n == 1)
    assert slips > plain_ops + 10
