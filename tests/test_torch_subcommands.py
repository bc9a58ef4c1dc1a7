"""The port's host subcommands against the JAX package's CLI, byte for byte.

``methylation-candidates``, ``filter-calls posterior-odds``,
``decode-phred``, ``genotype``, ``estimate mutational-burden`` (every
mode), ``plot scatter`` and ``plot variant-calling-prior`` run through
``varlociraptor_tpu.cli.run`` and ``varlociraptor_tpu_torch.cli.run`` on the
same inputs, all made here: the tumor-normal calls of
``synth_observation_files`` and of the all-kinds world
(``bench_utils.KINDS_WORLD``, preprocessed and called
by the port on the CPU), the annotated single-sample calls of
tests/test_burden_scatter.py's fixture, the CpGs of the world's FASTA, and
the trio scenario of ``bench_utils``.  Output files and standard output must
be byte-identical.
"""

import yaml
import pytest

from varlociraptor_tpu import cli as jax_cli
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.bench_utils import (
    KINDS_WORLD,
    TRIO_SCENARIO,
    synth_observation_files,
    synth_preprocess_world,
)

from test_burden_scatter import _annotate, calls  # noqa: F401  (a fixture)
from test_torch_preprocess_kinds import one_torch_thread  # noqa: F401


def _cpu_calls(tumor, normal, out):
    assert cli.run(["call", "variants", "tumor-normal", "--tumor", tumor, "--normal",
                    normal, "--purity", "0.75", "--device", "cpu", "--output", str(out)]) == 0
    return str(out)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("subcommands")
    tumor, normal, _ = synth_observation_files(tmp / "synth", n_loci=300, seed=5,
                                               frac_somatic=0.2, frac_germline=0.2)
    w = synth_preprocess_world(tmp / "world", **KINDS_WORLD)
    obs = {}
    for sample in ("tumor", "normal"):
        obs[sample] = str(tmp / f"{sample}.obs")
        assert cli.run(["preprocess", "variants", w["fasta"], "--bam", w[sample],
                        "--candidates", w["candidates"], "--output", obs[sample],
                        "--sample-name", sample, "--device", "cpu"]) == 0
    trio = tmp / "trio.yaml"
    trio.write_text(yaml.safe_dump(TRIO_SCENARIO))
    return {"synth": _cpu_calls(tumor, normal, tmp / "synth_calls.vcf"),
            "world": _cpu_calls(obs["tumor"], obs["normal"], tmp / "world_calls.vcf"),
            "fasta": w["fasta"], "trio": str(trio)}


def _both(argv, tmp_path, capsys, out_flag=None, positional_out=False):
    """Run ``argv`` through both CLIs; returns the two outputs (files or
    standard output) as bytes."""
    got = []
    for name, run in (("jax", jax_cli.run), ("torch", cli.run)):
        out = tmp_path / f"{name}.out"
        extra = [str(out)] if positional_out else ([out_flag, str(out)] if out_flag else [])
        assert run(argv + extra) == 0, name
        stdout = capsys.readouterr().out
        got.append(out.read_bytes() if extra else stdout.encode())
    return got


CALL_COMMANDS = {
    "posterior_odds": (["filter-calls", "posterior-odds", "{calls}", "--events",
                        "somatic_tumor", "germline_het", "--odds", "strong"], "--output"),
    "posterior_odds_barely": (["filter-calls", "posterior-odds", "{calls}", "--events",
                               "somatic_tumor", "--odds", "barely"], "--output"),
    "decode_phred": (["decode-phred", "{calls}"], "--output"),
    "genotype": (["genotype", "{calls}"], "--output"),
    "scatter": (["plot", "scatter", "{calls}", "--sample-x", "normal", "--sample-y",
                 "tumor"], None),
}


@pytest.mark.parametrize("source", ["synth", "world"])
@pytest.mark.parametrize("command", sorted(CALL_COMMANDS))
def test_calls_subcommand_is_byte_identical(inputs, tmp_path, capsys, command, source):
    argv, out_flag = CALL_COMMANDS[command]
    argv = [a.replace("{calls}", inputs[source]) for a in argv]
    jax_out, port_out = _both(argv, tmp_path, capsys, out_flag)
    assert jax_out == port_out
    assert len(port_out) > 200
    if command.startswith("posterior_odds"):
        kept = [ln for ln in port_out.decode().splitlines() if not ln.startswith("#")]
        assert kept, "the filter kept nothing: the comparison would be empty"


@pytest.mark.parametrize("mode", ["curve", "hist", "multibar", "table"])
def test_mutational_burden_is_byte_identical(calls, tmp_path, capsys, mode):  # noqa: F811
    annotated = _annotate(calls, tmp_path)
    jax_out, port_out = _both(["estimate", "mutational-burden", str(annotated), "--events",
                               "present", "--sample", "s", "--mode", mode], tmp_path, capsys)
    assert jax_out == port_out and len(port_out) > 100


@pytest.mark.parametrize("motif", ["CG", "CG,CHG,CHH,GATC"])
def test_methylation_candidates_are_byte_identical(inputs, tmp_path, capsys, motif):
    jax_out, port_out = _both(["methylation-candidates", inputs["fasta"], "--motif", motif],
                              tmp_path, capsys, positional_out=True)
    assert jax_out == port_out
    n = sum(1 for ln in port_out.decode().splitlines() if not ln.startswith("#"))
    assert n > 1000  # a 40 kb random contig holds ~2,500 CpGs


@pytest.mark.parametrize("sample", ["child", "mother"])
def test_prior_plot_is_byte_identical(inputs, tmp_path, capsys, sample):
    jax_out, port_out = _both(["plot", "variant-calling-prior", "--scenario", inputs["trio"],
                               "--contig", "chr1", "--sample", sample], tmp_path, capsys)
    assert jax_out == port_out and b'"values"' in port_out
