"""The port's ``estimate contamination`` (estimation/contamination.py) against
the JAX package.

The input is tests/test_contamination.py's fixture, rebuilt here: 24 SNV
loci whose sample VAFs are a somatic spectrum scaled by purity 0.7, beside a
clean contaminant.  Both packages run their legacy per-WorkItem caller with
the contamination scenario, the candidate filter and the call processor;
the port's engine runs with ``device="cpu"``.

Tolerance.  The posterior table is a sum over the informative variants of
their interpolated AFD log densities, less the log marginal.  The AFDs
reach the processor as deci-PHRED integers, and the two engines' read sums
(float32 in XLA's order, float64 in the port) may round a density to the
neighbouring step: 0.1 PHRED = ln(10) / 100 = 0.0230 nats per AFD entry.
One step on every variant's entry bounds a row's joint by 0.0230 * n and
the marginal by the same, so each finite log density must agree within
2 * 0.0230 * n_variants nats (the fixture's measured maximum is 0.016).  The
top row (the most likely contamination and maximum somatic VAF), the number
of informative variants and the set of finite rows must be equal; the MAP
VAFs agree within ``compare.AF_TOL``.
"""

import io
import math

import numpy as np
import pytest

from varlociraptor_tpu import cli as jcli
from varlociraptor_tpu.calling.observations import ObservationWriter
from varlociraptor_tpu.calling.variants import VariantInfo
from varlociraptor_tpu.estimation import contamination as jcont
from varlociraptor_tpu.evidence.observation import (
    Pileup,
    ReadObservation,
    set_prob_mapping,
    set_prob_overlap,
)
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.compare import AF_TOL
from varlociraptor_tpu_torch.estimation import contamination as tcont

TRUE_CONTAMINATION = 0.3  # purity 0.7
DPHRED_NATS = math.log(10.0) / 100.0


def _obs(alt: bool):
    o = ReadObservation()
    set_prob_mapping(o, -1e-9)
    o.prob_alt = -1e-9 if alt else math.log(1e-8)
    o.prob_ref = math.log(1e-8) if alt else -1e-9
    o.prob_missed_allele = math.log(0.5)
    o.prob_sample_alt = 0.0
    set_prob_overlap(o, -math.inf)
    return o


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """tests/test_contamination.py::_write_fixture."""
    d = tmp_path_factory.mktemp("contamination")
    purity = 1.0 - TRUE_CONTAMINATION
    depth = 60
    true_vafs = np.linspace(0.1, 1.0, 24)
    paths = {}
    for name in ("sample", "contaminant"):
        path = d / f"{name}.obs.jsonl"
        with ObservationWriter(path, sample_name=name) as w:
            for i, v in enumerate(true_vafs):
                if name == "sample":
                    k = int(round(depth * purity * v))
                    pile = Pileup(read_observations=[_obs(True) for _ in range(k)]
                                  + [_obs(False) for _ in range(depth - k)])
                else:
                    pile = Pileup(read_observations=[_obs(False) for _ in range(30)])
                w.write_record(
                    VariantInfo(kind="snv", chrom="chr1", pos=1000 + 100 * i,
                                ref_allele="A", alt_allele="T", alt_base="T"),
                    pile,
                )
        paths[name] = str(path)
    return paths


def _assert_tables_agree(ref, got):
    n = ref["n_variants"]
    assert got["n_variants"] == n
    tol = 2 * DPHRED_NATS * n
    assert abs(got["max_vaf"] - ref["max_vaf"]) <= AF_TOL
    top_r, top_g = ref["rows"][0], got["rows"][0]
    assert (top_g["expected_max_somatic_vaf"], top_g["contamination"]) == (
        top_r["expected_max_somatic_vaf"], top_r["contamination"])
    assert got["max_posterior_contamination"] == ref["max_posterior_contamination"]
    key = lambda r: (r["expected_max_somatic_vaf"], r["contamination"])  # noqa: E731
    dr = {key(r): r["log_density"] for r in ref["rows"]}
    dg = {key(r): r["log_density"] for r in got["rows"]}
    assert dr.keys() == dg.keys()
    fin = [k for k in dr if np.isfinite(dr[k])]
    assert fin and set(fin) == {k for k in dg if np.isfinite(dg[k])}
    err = max(abs(dr[k] - dg[k]) for k in fin)
    assert err <= tol, (err, tol)
    assert got["prior"] == ref["prior"]
    return err


@pytest.mark.parametrize("prior", [None, (0.6, 1000)], ids=["flat", "pathologist"])
def test_estimate_matches_jax(fixture, prior):
    ref = jcont.estimate_contamination(fixture["sample"], fixture["contaminant"],
                                       prior_estimate=prior)
    got = tcont.estimate_contamination(fixture["sample"], fixture["contaminant"],
                                       prior_estimate=prior, device="cpu")
    assert ref["n_variants"] >= 20
    _assert_tables_agree(ref, got)
    if prior is None:
        assert abs(got["rows"][0]["contamination"] - TRUE_CONTAMINATION) <= 0.05


def _tsv_rows(text):
    lines = text.splitlines()
    return lines[0], [line.split("\t") for line in lines[1:]]


def test_write_tsv_text(fixture):
    ref = jcont.estimate_contamination(fixture["sample"], fixture["contaminant"])
    got = tcont.estimate_contamination(fixture["sample"], fixture["contaminant"],
                                       device="cpu")
    tol = 2 * DPHRED_NATS * ref["n_variants"]
    # the same table through both writers is the same text
    a, b = io.StringIO(), io.StringIO()
    jcont.write_tsv(ref, a)
    tcont.write_tsv(ref, b)
    assert a.getvalue() == b.getvalue()
    # the port's table: the header and the top row's keys identical, every
    # density within the tolerance
    b = io.StringIO()
    tcont.write_tsv(got, b)
    head_r, rows_r = _tsv_rows(a.getvalue())
    head_g, rows_g = _tsv_rows(b.getvalue())
    assert head_g == head_r == "maximum somatic VAF\tcontamination\tposterior density"
    assert rows_g[0][:2] == rows_r[0][:2]
    dens = {tuple(r[:2]): float(r[2]) for r in rows_r}
    assert {tuple(r[:2]) for r in rows_g} == dens.keys()
    for r in rows_g:
        x, y = dens[tuple(r[:2])], float(r[2])
        assert (x == 0.0) == (y == 0.0)
        if x > 0.0:
            assert abs(math.log(y) - math.log(x)) <= tol


def test_cli_matches_jax(fixture, tmp_path, capsys):
    argv = ["estimate", "contamination", "--sample", fixture["sample"],
            "--contaminant", fixture["contaminant"]]
    outs = {}
    for name, run, extra in (("jax", jcli.run, []), ("torch", cli.run, ["--device", "cpu"])):
        out = tmp_path / f"{name}.tsv"
        vaf = tmp_path / f"{name}.maxvaf.tsv"
        plot = tmp_path / f"{name}.plot.json"
        assert run(argv + extra + ["--output", str(out), "--output-plot", str(plot),
                                   "--output-max-vaf-variants", str(vaf)]) == 0
        outs[name] = (out.read_text(), vaf.read_text(), plot.read_text())
        assert "max posterior contamination: 0.3000" in capsys.readouterr().err
    (tsv_r, vaf_r, _), (tsv_g, vaf_g, plot_g) = outs["jax"], outs["torch"]
    head_r, rows_r = _tsv_rows(tsv_r)
    head_g, rows_g = _tsv_rows(tsv_g)
    assert head_g == head_r and rows_g[0][:2] == rows_r[0][:2]
    assert len(rows_g) == len(rows_r)
    assert vaf_g == vaf_r
    assert '"empirical_vaf_dist"' in plot_g
    # the pathologist prior needs both flags
    assert cli.run(argv + ["--device", "cpu", "--prior-estimate", "0.5"]) == 1
    args = cli.build_parser().parse_args(argv)
    assert args.device == "cuda"
