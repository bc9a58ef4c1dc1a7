"""The port's CNV caller (calling/cnvs.py) against the JAX package.

* ``viterbi``: the port's torch loop (``device="cpu"``) against JAX's
  ``lax.scan`` on seeded random emission matrices, on matrices with exact
  ties (emissions on a coarse lattice) and on constructed near-ties, where a
  float64 recursion takes another path than the float32 one.  The decoded
  state paths must be identical: both run the recursion in float32 and take
  the first index among equal maxima.
* ``call_cnvs``: the VCF text byte-identical to JAX's on the fixtures of
  tests/test_cnvs.py (the calls alone, and with ``--tumor-obs`` /
  ``--normal-obs`` observation files carrying the depth channel).
* the CLI ``call cnvs --device cpu`` against the JAX CLI, byte for byte.
"""

import math

import numpy as np
import pytest

from varlociraptor_tpu import cli as jcli
from varlociraptor_tpu.calling import cnvs as jcnvs
from varlociraptor_tpu.calling.observations import ObservationWriter
from varlociraptor_tpu.calling.variants import VariantInfo
from varlociraptor_tpu.evidence.observation import Pileup
from varlociraptor_tpu.io.vcf import VcfRecord, VcfWriter
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.calling import cnvs
from test_cnvs import _calls_vcf

K = jcnvs.CnvStates.build(0.95).n  # 221 states


def _f64_path(obs, min_bayes_factor):
    """The same recursion in float64 on the host (what the float32 rule is
    held against)."""
    T, k = obs.shape
    eps = min_bayes_factor - 1.0
    keep, change = math.log((1.0 + eps) / (k + eps)), math.log(1.0 / (k + eps))
    delta = np.full(k, -math.log(k)) + obs[0]
    bps = np.zeros((T - 1, k), np.int64)
    for t in range(1, T):
        stay, move = delta + keep, delta.max() + change
        bps[t - 1] = np.where(stay >= move, np.arange(k), np.argmax(delta))
        delta = obs[t] + np.maximum(stay, move)
    states = np.zeros(T, np.int64)
    states[-1] = np.argmax(delta)
    for t in range(T - 2, -1, -1):
        states[t] = bps[t, states[t + 1]]
    return states


@pytest.mark.parametrize("T,k,mbf,seed", [
    (2, 3, 1.01, 0), (2, K, 1e3, 1), (60, K, 1.01, 2), (60, K, 1e3, 3),
    (400, K, 1e6, 4), (400, 7, 1.5, 5),
])
def test_viterbi_matches_jax(T, k, mbf, seed):
    rng = np.random.default_rng(seed)
    obs = rng.normal(-20.0, 8.0, (T, k))
    obs[rng.random((T, k)) < 0.05] = -np.inf  # impossible states
    assert np.array_equal(cnvs.viterbi(obs, mbf, device="cpu"),
                          jcnvs.viterbi(obs, mbf))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_ties_take_the_first_index(seed):
    """Emissions on a lattice of 0.5: equal maxima and stay == move ties in
    every step."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(-8, 1, (200, 12)) * 0.5
    obs[:, 7] = obs[:, 2]
    got = cnvs.viterbi(obs, 2.0, device="cpu")
    assert np.array_equal(got, jcnvs.viterbi(obs, 2.0))


def test_viterbi_near_ties_follow_float32():
    """Two states whose stay and move differ below float32 resolution: the
    float64 recursion keeps state 1's own path, float32 sees a tie (or the
    other order) and the argmax decides.  The port follows JAX's float32."""
    mbf = 1e3
    eps = mbf - 1.0
    keep, change = math.log((1.0 + eps) / (2 + eps)), math.log(1.0 / (2 + eps))
    differ = 0
    for i, tiny in enumerate(np.geomspace(1e-12, 1e-6, 40)):
        obs = np.zeros((3, 2))
        obs[0, 1] = change - keep + tiny * (-1) ** i
        obs[1] = [0.0, 0.0]
        obs[2] = [0.0, 50.0]
        ref = jcnvs.viterbi(obs, mbf)
        assert np.array_equal(cnvs.viterbi(obs, mbf, device="cpu"), ref), (tiny, ref)
        differ += not np.array_equal(_f64_path(obs, mbf), ref)
    assert differ, "no constructed case separates float32 from float64"


def _depth_fixture(tmp_path):
    """tests/test_cnvs.py::test_cnv_depth_from_observation_files's input:
    flat FORMAT DP in the calls, the true amplified depth in the tumor's
    observation files."""
    rng = np.random.default_rng(7)
    header = [
        '##INFO=<ID=PROB_GERMLINE_HET,Number=A,Type=Float,Description="x">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="x">',
        '##FORMAT=<ID=AF,Number=1,Type=Float,Description="x">',
    ]
    calls = tmp_path / "depth_calls.vcf"
    writers = {s: ObservationWriter(tmp_path / f"{s}.obs.jsonl", sample_name=s)
               for s in ("tumor", "normal")}
    with VcfWriter(calls, sample_names=["tumor", "normal"], header_lines=header) as w:
        for i in range(60):
            in_cnv = 20 <= i < 40
            pos = 1000 + i * 500
            d_t = int(rng.poisson(80 if in_cnv else 40))
            af_t = ((1 / 4 if rng.random() < 0.5 else 3 / 4) if in_cnv
                    else 0.5 + rng.normal(0, 0.02))
            w.write(VcfRecord(
                chrom="chr1", pos=pos, id=".", ref="A", alts=["T"],
                info={"PROB_GERMLINE_HET": "0.01"}, format=["DP", "AF"],
                samples=[{"DP": "40", "AF": f"{af_t:.4f}"}, {"DP": "40", "AF": "0.5"}],
            ))
            vi = VariantInfo(kind="snv", chrom="chr1", pos=pos, ref_allele="A",
                             alt_allele="T", alt_base="T")
            writers["tumor"].write_record(vi, Pileup(read_observations=[], raw_depth=d_t))
            writers["normal"].write_record(vi, Pileup(read_observations=[], raw_depth=40))
    for w_ in writers.values():
        w_.close()
    return calls, tmp_path / "tumor.obs.jsonl", tmp_path / "normal.obs.jsonl"


@pytest.mark.parametrize("case", ["calls", "calls_mbf", "with_obs", "without_obs"])
def test_call_cnvs_vcf_is_byte_identical(case, tmp_path):
    kw = dict(tumor_sample="tumor", normal_sample="normal", purity=0.95,
              min_bayes_factor=1e3)
    if case.startswith("calls"):
        calls = tmp_path / "calls.vcf"
        _calls_vcf(calls)
        if case == "calls_mbf":
            kw.update(min_bayes_factor=1.01, purity=0.7, max_dist=4000)
    else:
        calls, t_obs, n_obs = _depth_fixture(tmp_path)
        if case == "with_obs":
            kw.update(tumor_obs=t_obs, normal_obs=n_obs)
    ref, got = tmp_path / "jax.vcf", tmp_path / "torch.vcf"
    n_ref = jcnvs.call_cnvs(calls, ref, **kw)
    n_got = cnvs.call_cnvs(calls, got, device="cpu", **kw)
    assert n_got == n_ref
    assert got.read_bytes() == ref.read_bytes()
    if case in ("calls", "with_obs"):
        assert n_ref >= 1


def test_cli_call_cnvs_matches_jax(tmp_path, capsys):
    calls, t_obs, n_obs = _depth_fixture(tmp_path)
    argv = ["call", "cnvs", str(calls), "--purity", "0.95", "--min-bayes-factor",
            "1000", "--tumor-obs", str(t_obs), "--normal-obs", str(n_obs)]
    assert jcli.run(argv + ["--output", str(tmp_path / "jax.vcf")]) == 0
    assert cli.run(argv + ["--device", "cpu", "--output", str(tmp_path / "torch.vcf")]) == 0
    assert (tmp_path / "torch.vcf").read_bytes() == (tmp_path / "jax.vcf").read_bytes()
    assert "CNV segments" in capsys.readouterr().err
    args = cli.build_parser().parse_args(["call", "cnvs", "c.vcf", "--purity", "1",
                                          "--output", "o"])
    assert args.device == "cuda"
