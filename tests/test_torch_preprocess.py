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


@pytest.mark.parametrize("flags,match", [(["--threads", "2"], "A12")])
def test_cli_refuses_what_is_not_ported(world, tmp_path, flags, match):
    out = tmp_path / "x.obs"
    with pytest.raises(NotImplementedError, match=match):
        cli.run(["preprocess", "variants", world["fasta"], "--bam", world["tumor"],
                 "--candidates", world["candidates"], "--output", str(out),
                 "--device", "cpu", *flags])
    assert not out.exists()


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
