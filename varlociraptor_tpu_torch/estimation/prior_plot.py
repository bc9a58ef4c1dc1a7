"""`plot variant-calling-prior`: vega-lite visualization of the prior.

Mirrors ``Prior::plot`` (``src/variants/model/prior.rs:143-236``):
enumerate all joint VAF events over each sample's contig universe
(discretized at the sample resolution), compute the prior for each, and emit
a layered vega-lite spec where the target sample's prior mass is plotted per
VAF, grouped ("hash") by the other samples' VAF combination.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math


def _universe_points(universe, resolution: float):
    pts = set()
    for sp in universe:
        if sp.is_set:
            pts.update(float(v) for v in sp.set_values)
        else:
            r = sp.range_value
            start, end = float(r.start), float(r.end)
            n = max(1, round((end - start) / max(resolution, 1e-9)))
            for i in range(n + 1):
                v = start + (end - start) * i / n
                if r.contains(v):
                    pts.add(round(v, 9))
    return sorted(pts)


def plot_variant_calling_prior(scenario, contig: str, target_sample: str) -> dict:
    from ..ops.prior import build_prior

    prior = build_prior(scenario, contig)
    prior.is_absent_only = False  # full prior, pointwise
    names = scenario.sample_names
    grids = []
    for n in names:
        s = scenario.samples[n]
        res = float(getattr(s, "resolution", 0.01) or 0.01)
        grids.append(
            _universe_points(s.contig_universe(contig, scenario.species), res)
        )

    total = 1
    for g in grids:
        total *= max(len(g), 1)
    if total > 2_000_000:
        raise ValueError(
            f"prior plot grid too large ({total} events); "
            "coarsen sample resolutions"
        )

    data = []
    visited = set()
    for vafs in itertools.product(*grids):
        p = prior.compute(list(vafs))
        prob = math.exp(p) if p > -700 else 0.0
        if prob == 0.0:
            continue
        other = ",".join(
            json.dumps({"sample": n, "vaf": v}, sort_keys=True)
            for n, v in zip(names, vafs)
            if n != target_sample
        )
        h = hashlib.sha256(other.encode()).hexdigest()[:8].upper()
        for n, v in zip(names, vafs):
            if n == target_sample:
                data.append(
                    {"sample": n, "prob": prob, "vaf": v, "hash": h}
                )
            elif h not in visited:
                data.append({"sample": n, "vaf": v, "hash": h})
        visited.add(h)

    return {
        "$schema": "https://vega.github.io/schema/vega-lite/v5.json",
        "description": f"variant calling prior for sample {target_sample} on contig {contig}",
        "data": {"values": data},
        "facet": {"row": {"field": "hash", "type": "nominal", "title": "other-sample VAF combination"}},
        "spec": {
            "layer": [
                {
                    "transform": [
                        {"filter": f"datum.sample != '{target_sample}'"}
                    ],
                    "mark": "rule",
                    "encoding": {
                        "x": {"field": "vaf", "type": "quantitative"},
                        "color": {"field": "sample", "type": "nominal"},
                    },
                },
                {
                    "transform": [
                        {"filter": {"field": "sample", "equal": target_sample}}
                    ],
                    "mark": {"type": "bar", "width": 2},
                    "encoding": {
                        "x": {
                            "field": "vaf",
                            "type": "quantitative",
                            "scale": {"domain": [0.0, 1.0]},
                        },
                        "y": {"field": "prob", "type": "quantitative"},
                        "color": {"field": "sample", "type": "nominal"},
                    },
                },
            ]
        },
    }
