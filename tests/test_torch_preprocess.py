"""The port's preprocess (BAM -> observations) against the JAX package.

A tiny seeded world (``bench_utils.synth_preprocess_world``: 20 kb, 6x
paired-end, 16 germline + 12 somatic + 12 decoy indel candidates and 10 SNV
candidates) goes through the JAX ``preprocess`` on its kernel path (the
Pallas K2 / K3 in interpret mode, as tests/test_pallas_pairhmm.py runs them;
the native host forward switched off) and through the port's
``preprocess(..., device="cpu")`` (the plain K2 / K3), once with the gap
model ``estimate()`` gives on this world (zero extension: K2) and once with
finite ONT-like extensions (K3).

Tolerance (``compare.compare_observation_files``): the same records and read
counts, every field the pair-HMM does not touch identical, and prob_alt,
prob_ref, prob_missed_allele within 5e-4 * max(1, |x|) plus one float16
step of the file, or both below -30.  Measured on this world: every value
above -30 is identical (largest relative error 0.0); below -30, 62 read
values of the K2 runs and 4 of the K3 runs differ, by up to whole units
(XLA flushes float32 denormals, torch keeps them; see
test_torch_pairhmm.py::test_denormals_explain_the_difference_from_xla).

Then the port's CLI runs estimate -> preprocess (tumor, normal) -> call ->
filter-calls on the same world with ``--device cpu``.
"""

import json
import math

import pytest

import varlociraptor_tpu.ops.pallas_pairhmm as jpp
from varlociraptor_tpu.calling.preprocess import PreprocessOptions as JaxOptions
from varlociraptor_tpu.calling.preprocess import preprocess as jax_preprocess
from varlociraptor_tpu.estimation.alignment_properties import (
    AlignmentProperties,
    GapParams,
    estimate,
)
from varlociraptor_tpu.io.bam import BamReader
from varlociraptor_tpu.io.fasta import FastaBuffer
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.bench_utils import synth_preprocess_world
from varlociraptor_tpu_torch.calling.preprocess import PreprocessOptions, preprocess
from varlociraptor_tpu_torch.compare import compare_observation_files, vcf_record_keys
from varlociraptor_tpu_torch.ops import pairhmm_column as phc

ONT_GAPS = GapParams(math.log(5.1e-3), math.log(4.2e-3), math.log(0.35), math.log(0.42))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return synth_preprocess_world(
        tmp_path_factory.mktemp("world"), seed=1, genome_len=20_000, coverage=6.0,
        n_germline=16, n_somatic=12, n_decoy=12, n_snv=10,
    )


def _props(world, model):
    props = estimate(BamReader(world["normal"]), reference=FastaBuffer(world["fasta"]))
    if model == "ont":
        props.gap_params = ONT_GAPS
    return props.to_json()


def _counting(monkeypatch, module, name, **kw):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("model,kernel", [("estimated", "exact"), ("ont", "general")])
def test_preprocess_matches_jax(world, tmp_path, monkeypatch, model, kernel):
    props = _props(world, model)
    # the estimate on this small world keeps zero extension (K2)
    ext = json.loads(props)["gap_params"]["prob_insertion_extend_artifact"]
    assert (ext is None) == (kernel == "exact")
    # the JAX package on its kernel path: Pallas K2 / K3 in interpret mode
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "0")
    monkeypatch.setenv("VLT_PALLAS_PAIRHMM", "1")
    jax_calls = _counting(monkeypatch, jpp, f"pallas_{kernel}_forward", interpret=True)
    port_calls = _counting(monkeypatch, phc, f"{kernel}_forward")
    for sample in ("tumor", "normal"):
        ref, got = tmp_path / f"jax.{sample}.obs", tmp_path / f"torch.{sample}.obs"
        n_jax = jax_preprocess(
            world["candidates"], world[sample], world["fasta"], str(ref),
            sample_name=sample, alignment_properties=AlignmentProperties.from_json(props),
            options=JaxOptions(log_mode="silent"),
        )
        n_port = preprocess(
            world["candidates"], world[sample], world["fasta"], str(got),
            sample_name=sample, alignment_properties=AlignmentProperties.from_json(props),
            options=PreprocessOptions(log_mode="silent"), device="cpu",
        )
        assert n_jax == n_port == world["n_candidates"]
        problems, info = compare_observation_files(ref, got)
        assert not problems, problems
        assert info["records"] == world["n_candidates"] and info["reads"] > 100
        print(sample, model, info)
    # both ran their column kernels (per locus on the CPU), not another path
    assert jax_calls and port_calls


def test_cli_pipeline_on_cpu(world, tmp_path, capsys):
    props = tmp_path / "props.json"
    assert cli.run(["estimate", "alignment-properties", world["fasta"], "--bam",
                    world["normal"]]) == 0
    props.write_text(capsys.readouterr().out)
    assert AlignmentProperties.from_json(props.read_text()).max_read_len == 100
    obs = {}
    for sample in ("tumor", "normal"):
        obs[sample] = str(tmp_path / f"{sample}.obs")
        assert cli.run(["preprocess", "variants", world["fasta"], "--bam", world[sample],
                        "--candidates", world["candidates"], "--output", obs[sample],
                        "--sample-name", sample, "--alignment-properties", str(props),
                        "--device", "cpu"]) == 0
    calls, kept = tmp_path / "calls.vcf", tmp_path / "kept.vcf"
    assert cli.run(["call", "variants", "tumor-normal", "--tumor", obs["tumor"],
                    "--normal", obs["normal"], "--purity", "0.75", "--device", "cpu",
                    "--output", str(calls)]) == 0
    assert len(vcf_record_keys(calls.read_text())) == world["n_candidates"]
    assert cli.run(["filter-calls", "control-fdr", str(calls), "--events",
                    "somatic_tumor", "--fdr", "0.05", "--output", str(kept)]) == 0
    assert kept.exists()


@pytest.mark.parametrize(
    "flags,match",
    [(["--threads", "2"], "A12"), (["--pairhmm-mode", "homopolymer"], "A9")],
)
def test_cli_refuses_what_is_not_ported(world, tmp_path, flags, match):
    out = tmp_path / "x.obs"
    with pytest.raises(NotImplementedError, match=match):
        cli.run(["preprocess", "variants", world["fasta"], "--bam", world["tumor"],
                 "--candidates", world["candidates"], "--output", str(out),
                 "--device", "cpu", *flags])
    assert not out.exists()
