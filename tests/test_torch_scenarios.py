"""Scenarios through the call stage: the JAX ``call_generic`` and the port's
on the same synthetic observation files (one per sample,
bench_utils.synth_sample_observation_files), VCF text compared with
compare.compare_vcf_text (numbers within 1.1e-4 * max(1, |x|), AFD values
within one deci-PHRED step, every other byte identical).

The scenarios are those the port's call stage serves beyond tumor-normal: one
germline sample, tumor/normal with contamination at resolution 0.1, the
contaminated tumor/relapse/normal trio and the mendelian trio (each also with
--full-prior), and tumor/relapse/normal with l2fc events; and the CLI's
``call variants generic`` with a scenario file: tumor-normal with
--full-prior at the default resolution 0.01, and the l2fc scenario at 0.05
(at 0.01 its synthetic files hold a locus whose MAP AF sits on a density
peak that is flat at the printed resolution, where the log-parabola vertex
moves by 2e-4 with one-ulp float32 differences of its ~750-nat densities:
the case compare.compare_outputs allows for engine outputs and
compare_vcf_text does not)."""

import copy
import json

import pytest

from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.bench_utils import (
    L2FC_SCENARIO, TRIO_SCENARIO, synth_sample_observation_files,
)
from varlociraptor_tpu_torch.compare import compare_vcf_text, vcf_record_keys
from test_torch_engine_modes import CONTAM_TRIO_SCENARIO

N_LOCI = 48

GERMLINE_SCENARIO = {
    "samples": {"sample": {"universe": "[0.0,1.0]", "ploidy": 2}},
    "species": {"heterozygosity": 0.001},
    "events": {"het": "sample:0.5", "hom": "sample:1.0"},
}


def _tumor_normal(pkg):
    if pkg == "jax":
        from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario
    else:
        from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
    return tumor_normal_scenario(0.75)  # contamination 0.25


# name -> (scenario dict or builder, call resolution, --full-prior)
SCENARIOS = {
    "germline": (GERMLINE_SCENARIO, 0.01, False),
    "tumor_normal": (_tumor_normal, 0.1, False),
    "contam_trio": (CONTAM_TRIO_SCENARIO, 0.1, False),
    "trio": (TRIO_SCENARIO, 0.1, False),
    "contam_trio_full_prior": (CONTAM_TRIO_SCENARIO, 0.1, True),
    "trio_full_prior": (TRIO_SCENARIO, 0.1, True),
    "tumor_relapse_l2fc": (L2FC_SCENARIO, 0.05, False),
}


def _call(pkg, spec, res, full_prior, obs, out):
    if pkg == "jax":
        from varlociraptor_tpu.calling.call import CallOptions, call_generic
        from varlociraptor_tpu.grammar.scenario import Scenario

        kw = {}
    else:
        from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
        from varlociraptor_tpu_torch.grammar.scenario import Scenario

        kw = {"device": "cpu"}
    scenario = spec(pkg) if callable(spec) else Scenario(copy.deepcopy(spec))
    n = call_generic(
        scenario, obs, str(out),
        CallOptions(full_prior=full_prior, resolution=res), **kw,
    )
    assert n == N_LOCI
    return scenario


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_vcf_matches_jax(name, tmp_path):
    spec, res, full_prior = SCENARIOS[name]
    names = spec("torch").sample_names if callable(spec) else sorted(spec["samples"])
    obs = synth_sample_observation_files(tmp_path / "obs", names, n_loci=N_LOCI, seed=7)
    ref_vcf, got_vcf = tmp_path / "jax.vcf", tmp_path / "torch.vcf"
    _call("jax", spec, res, full_prior, obs, ref_vcf)
    _call("torch", spec, res, full_prior, obs, got_vcf)
    ref, got = ref_vcf.read_text(), got_vcf.read_text()
    assert len(vcf_record_keys(got)) == N_LOCI
    problems, swapped = compare_vcf_text(ref, got)
    assert not problems, problems[:5]
    if swapped:
        print("AFD top-K swaps between equal-density points, lines:", swapped)


@pytest.mark.parametrize("name", ["tumor_normal_full_prior", "tumor_relapse_l2fc"])
def test_cli_generic_matches_jax(name, tmp_path):
    from varlociraptor_tpu.calling.call import CallOptions, call_generic
    from varlociraptor_tpu.grammar.scenario import Scenario

    full_prior = name.endswith("full_prior")
    doc = _tumor_normal("torch").doc if full_prior else L2FC_SCENARIO
    (tmp_path / "scenario.yaml").write_text(json.dumps(doc))  # JSON is YAML
    n_loci = 64
    obs = synth_sample_observation_files(
        tmp_path / "obs", sorted(doc["samples"]), n_loci=n_loci, seed=11
    )
    ref_vcf, got_vcf = tmp_path / "jax.vcf", tmp_path / "torch.vcf"
    res = 0.01 if full_prior else 0.05
    call_generic(Scenario(copy.deepcopy(doc)), obs, str(ref_vcf),
                 CallOptions(full_prior=full_prior, resolution=res))
    argv = ["call", "variants", "generic", "--scenario", str(tmp_path / "scenario.yaml"),
            "--obs", *(f"{k}={v}" for k, v in obs.items()), "--resolution", str(res),
            "--device", "cpu", "--output", str(got_vcf)]
    assert cli.run(argv + (["--full-prior"] if full_prior else [])) == 0
    ref, got = ref_vcf.read_text(), got_vcf.read_text()
    assert len(vcf_record_keys(got)) == n_loci
    problems, swapped = compare_vcf_text(ref, got)
    assert not problems, problems[:5]
    if swapped:
        print("AFD top-K swaps between equal-density points, lines:", swapped)
