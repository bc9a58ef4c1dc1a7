"""Contamination estimation between a sample and a contaminant.

Faithful port of ``src/estimation/contamination.rs``: the
generic caller runs a two-sample denovo/other scenario with the reference's
candidate filter (SNVs whose contaminant pileup is deep clean-ref and whose
sample pileup has strong alt support, ``contamination.rs:404-427``); each
confident denovo call contributes its full per-sample VAF posterior density
(AFD) as a ``VariantObservation`` (``:36-115``); the contamination posterior
integrates, over a Simpson grid of contamination fractions and four
"expected maximum somatic VAF" levels, the interpolated AFD density at the
purity-scaled expected VAF (``:159-233``), with an optional binomial
"pathologist" prior from a counted-cells estimate (``:117-156``).
"""

from __future__ import annotations

import json
import math

import numpy as np

from ..calling.call import CallOptions, call_generic
from ..grammar.scenario import Scenario
from ..utils.logprob import LOG_ZERO, np_ln_one_minus_exp, np_ln_sum_exp

# the built-in scenario (contamination.rs:438-452)
_SCENARIO = {
    "samples": {
        "sample": {"universe": "[0.0,1.0]", "resolution": 0.01},
        "contaminant": {"universe": "[0.0,1.0]", "resolution": 0.01},
    },
    "events": {
        "denovo": "sample:]0.0,1.0] & contaminant:0.0",
        "other": "sample:[0.0,1.0] & contaminant:]0.0,1.0]",
    },
}

EXPECTED_MAX_SOMATIC_VAFS = (0.25, 0.5, 0.75, 1.0)


class VariantObservation:
    """contamination.rs:36-115."""

    def __init__(self, chrom, pos, vaf_dist, prob_denovo, max_posterior_vaf):
        self.chrom = chrom
        self.pos = pos
        # sorted (vaf, log density) pairs
        self.vaf_dist = sorted(vaf_dist.items())
        self.prob_denovo = prob_denovo
        self.max_posterior_vaf = max_posterior_vaf

    def pdf(self, vaf: float) -> float:
        """Piecewise-linear interpolation of the AFD (contamination.rs:82-115)."""
        import bisect

        keys = [v for v, _ in self.vaf_dist]
        i = bisect.bisect_left(keys, vaf)
        if i < len(keys) and abs(keys[i] - vaf) < 1e-12:
            return self.vaf_dist[i][1]
        if i == 0 or i >= len(keys):
            return LOG_ZERO  # outside the support
        (v0, d0), (v1, d1) = self.vaf_dist[i - 1], self.vaf_dist[i]
        t = (vaf - v0) / (v1 - v0)
        lin = math.exp(d0) + (math.exp(d1) - math.exp(d0)) * t
        return math.log(lin) if lin > 0 else LOG_ZERO


def _ln_binomial_pmf(k: int, n: int, p: float) -> float:
    if p <= 0.0:
        return 0.0 if k == 0 else LOG_ZERO
    if p >= 1.0:
        return 0.0 if k == n else LOG_ZERO
    return (
        math.lgamma(n + 1)
        - math.lgamma(k + 1)
        - math.lgamma(n - k + 1)
        + k * math.log(p)
        + (n - k) * math.log(1 - p)
    )


def _prior(contamination: float, prior_estimate) -> float:
    """contamination.rs:117-156: flat, or binomial from counted cells."""
    if prior_estimate is None:
        return 0.0
    frac, n_cells = prior_estimate
    k = int(round(frac * n_cells))
    return _ln_binomial_pmf(k, n_cells, contamination)


def _make_candidate_filter(sample_idx: int, cont_idx: int):
    """ContaminationCandidateFilter (contamination.rs:404-427); indices are
    looked up by name like the reference (sample order in the compiled
    scenario is not the YAML order)."""

    def _filter(item) -> bool:
        if item.snv is None:
            return False
        cont = item.pileups[cont_idx].read_observations
        samp = item.pileups[sample_idx].read_observations
        return (
            len(cont) >= 10
            and all(o.is_ref_support() for o in cont)
            and len(samp) >= 10
            and any(o.is_strong_alt_support() for o in samp)
        )

    return _filter


def _simpson_lse(values: list[float], a: float, b: float) -> float:
    """log Simpson integral over n (odd) equally spaced log values."""
    n = len(values)
    h = (b - a) / (n - 1)
    coefs = np.full(n, math.log(4.0))
    coefs[0::2] = math.log(2.0)
    coefs[0] = coefs[-1] = 0.0
    return math.log(h / 3.0) + np_ln_sum_exp(np.asarray(values) + coefs)


def estimate_contamination(
    sample_obs_path,
    contaminant_obs_path,
    prior_estimate: tuple[float, int] | None = None,
    resolution: int = 100,
    device="cuda",
):
    """Returns the posterior table over (expected max somatic VAF,
    contamination) plus observation metadata.

    prior_estimate: (contamination fraction, n considered cells) — the
    --prior-estimate / --prior-considered-cells pathologist prior.
    device: where the caller's posterior engine runs ("cuda" or "cpu").
    """
    import os
    import tempfile

    scenario = Scenario(_SCENARIO)
    sample_idx = scenario.sample_names.index("sample")
    cont_idx = scenario.sample_names.index("contaminant")
    observations = []

    def processor(res):
        probs = res["event_probs"]
        prob_denovo = probs.get("denovo", LOG_ZERO)
        info = res["sample_infos"][sample_idx]
        if info["afd"] is None or math.exp(prob_denovo) < 0.95:
            return
        observations.append(
            VariantObservation(
                res["variant"].chrom,
                res["variant"].pos,
                info["afd"],
                prob_denovo,
                info["af"],
            )
        )

    sink = os.path.join(tempfile.mkdtemp(prefix="vlt-contam-"), "calls.vcf")
    call_generic(
        scenario,
        {"sample": sample_obs_path, "contaminant": contaminant_obs_path},
        sink,
        CallOptions(),
        call_processor=processor,
        candidate_filter=_make_candidate_filter(sample_idx, cont_idx),
        device=device,
    )

    max_vaf = max((o.max_posterior_vaf for o in observations), default=0.0)
    grid = np.linspace(0.0, 1.0, resolution + 1)

    def likelihood(contamination: float, ems_vaf: float) -> float:
        purity = 1.0 - contamination
        total = 0.0
        for obs in observations:
            if purity == 0.0:
                total += np_ln_one_minus_exp(obs.prob_denovo)
                continue
            quantile = obs.max_posterior_vaf / max_vaf if max_vaf > 0 else 0.0
            expected_vaf = ems_vaf * purity * quantile
            total += obs.pdf(expected_vaf)
        return total

    rows = []
    curves = []
    for ems in EXPECTED_MAX_SOMATIC_VAFS:
        joints = [
            _prior(c, prior_estimate) + likelihood(c, ems) for c in grid
        ]
        curves.append(joints)
        for c, j in zip(grid, joints):
            rows.append({"expected_max_somatic_vaf": ems, "contamination": float(c), "joint": j})
    marginal = np_ln_sum_exp(
        np.array([_simpson_lse(j, 0.0, 1.0) for j in curves])
    )
    for r in rows:
        r["log_density"] = (
            r.pop("joint") - marginal if np.isfinite(marginal) else LOG_ZERO
        )
    # "the most likely fraction comes at the top" (cli.rs:450-457)
    rows.sort(key=lambda r: -r["log_density"])

    hist = {}
    for o in observations:
        b = math.floor(o.max_posterior_vaf * 100.0) / 100.0
        hist[b] = hist.get(b, 0) + 1
    return {
        "rows": rows,
        "max_posterior_contamination": rows[0]["contamination"] if rows else 0.0,
        "n_variants": len(observations),
        "max_vaf": max_vaf,
        "max_vaf_variants": [
            (o.chrom, o.pos)
            for o in observations
            if o.max_posterior_vaf == max_vaf
        ],
        "vaf_histogram": sorted(hist.items()),
        "prior": [
            {
                "purity": 1.0 - c,
                "density": math.exp(_prior(c, prior_estimate)),
                "category": "prior",
            }
            for c in np.linspace(0.0, 1.0, 101)
        ],
    }


def write_tsv(result, fh):
    """Reference TSV layout (contamination.rs:362-371)."""
    print("maximum somatic VAF\tcontamination\tposterior density", file=fh)
    for r in result["rows"]:
        print(
            f"{r['expected_max_somatic_vaf']}\t{r['contamination']}\t"
            f"{math.exp(r['log_density'])}",
            file=fh,
        )


def write_plot(result, path):
    """Vega-lite density/histogram plot (contamination.rs:320-346)."""
    densities = list(result["prior"])
    for r in result["rows"]:
        densities.append(
            {
                "purity": 1.0 - r["contamination"],
                "density": math.exp(r["log_density"]),
                "category": f"posterior, max VAF={r['expected_max_somatic_vaf']}",
            }
        )
    spec = {
        "$schema": "https://vega.github.io/schema/vega-lite/v4.json",
        "datasets": {
            "empirical_vaf_dist": [
                {"vaf": v, "count": c} for v, c in result["vaf_histogram"]
            ],
            "densities": densities,
        },
        "vconcat": [
            {
                "data": {"name": "densities"},
                "mark": "line",
                "encoding": {
                    "x": {"field": "purity", "type": "quantitative"},
                    "y": {"field": "density", "type": "quantitative"},
                    "color": {"field": "category", "type": "nominal"},
                },
            },
            {
                "data": {"name": "empirical_vaf_dist"},
                "mark": "bar",
                "encoding": {
                    "x": {"field": "vaf", "type": "quantitative"},
                    "y": {"field": "count", "type": "quantitative"},
                },
            },
        ],
    }
    with open(path, "w") as f:
        json.dump(spec, f, indent=2)
