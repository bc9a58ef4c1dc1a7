"""Two-sample VAF scatter plot with a density contour overlay (vega v5).

Port of ``src/estimation/sample_variants.rs:18-99`` +
``cli.rs:400-404``: records stream from a calls file, each alt allele
contributes one ``{sample, normal_vaf, tumor_vaf}`` point per requested
y-sample, and the blueprint overlays a kde2d density estimate (heatmap +
isocontours) on the scatter — the reference's
``templates/plots/vaf_scatter_contour.json`` semantics rebuilt as a
programmatic vega spec.
"""

from __future__ import annotations

import math

from ..errors import NoRecordsFoundError
from ..io.vcf import open_variant_file


def _scatter_contour_blueprint(values, xlabel: str) -> dict:
    """Vega v5 spec: grey scatter + per-sample kde2d heatmap and
    3-level isocontours, VAF axes fixed to [0, 1]."""
    linear01 = {
        "type": "linear",
        "round": True,
        "nice": True,
        "zero": True,
        "domain": [0, 1],
    }
    return {
        "$schema": "https://vega.github.io/schema/vega/v5.json",
        "description": (
            "Variant allelic fraction scatter overlaid with a 2D kernel "
            "density contour estimate per sample group"
        ),
        "width": 500,
        "height": 400,
        "padding": 5,
        "autosize": "pad",
        "signals": [
            {
                "name": "bandwidth",
                "value": -1,
                "bind": {"input": "range", "min": -1, "max": 100, "step": 1},
            },
            {
                "name": "resolve",
                "value": "shared",
                "bind": {
                    "input": "select",
                    "options": ["independent", "shared"],
                },
            },
            {"name": "counts", "value": True, "bind": {"input": "checkbox"}},
        ],
        "data": [
            {"name": "source", "values": values},
            {
                "name": "density",
                "source": "source",
                "transform": [
                    {
                        "type": "kde2d",
                        "groupby": ["sample"],
                        "size": [{"signal": "width"}, {"signal": "height"}],
                        "x": {"expr": "scale('x', datum.normal_vaf)"},
                        "y": {"expr": "scale('y', datum.tumor_vaf)"},
                        "bandwidth": {"signal": "[bandwidth, bandwidth]"},
                        "counts": {"signal": "counts"},
                    }
                ],
            },
            {
                "name": "contours",
                "source": "density",
                "transform": [
                    {
                        "type": "isocontour",
                        "field": "grid",
                        "resolve": {"signal": "resolve"},
                        "levels": 3,
                    }
                ],
            },
        ],
        "scales": [
            {"name": "x", "range": "width", **linear01},
            {"name": "y", "range": "height", **linear01},
            {
                "name": "color",
                "type": "ordinal",
                "domain": {
                    "data": "source",
                    "field": "sample",
                    "sort": {"order": "ascending"},
                },
                "range": "category",
            },
        ],
        "axes": [
            {
                "scale": "x",
                "grid": True,
                "domain": False,
                "orient": "bottom",
                "tickCount": 5,
                "title": xlabel,
            },
            {
                "scale": "y",
                "grid": True,
                "domain": False,
                "orient": "left",
                "tickCount": 5,
            },
        ],
        "legends": [
            {"title": "Sample", "stroke": "color", "symbolType": "stroke"}
        ],
        "marks": [
            {
                "name": "marks",
                "type": "symbol",
                "from": {"data": "source"},
                "encode": {
                    "update": {
                        "x": {"scale": "x", "field": "normal_vaf"},
                        "y": {"scale": "y", "field": "tumor_vaf"},
                        "size": {"value": 4},
                        "fill": {"value": "#ccc"},
                    }
                },
            },
            {
                "type": "image",
                "from": {"data": "density"},
                "encode": {
                    "update": {
                        "x": {"value": 0},
                        "y": {"value": 0},
                        "width": {"signal": "width"},
                        "height": {"signal": "height"},
                        "aspect": {"value": False},
                    }
                },
                "transform": [
                    {
                        "type": "heatmap",
                        "field": "datum.grid",
                        "resolve": {"signal": "resolve"},
                        "color": {
                            "expr": "scale('color', datum.datum.sample)"
                        },
                    }
                ],
            },
            {
                "type": "path",
                "clip": True,
                "from": {"data": "contours"},
                "encode": {
                    "enter": {
                        "strokeWidth": {"value": 1},
                        "strokeOpacity": {"value": 1},
                        "stroke": {"scale": "color", "field": "sample"},
                    }
                },
                "transform": [{"type": "geopath", "field": "datum.contour"}],
            },
        ],
    }


def vaf_scatter(calls_path, sample_x: str, sample_y):
    """sample_y: one sample name or a list (sample_variants.rs:18 takes
    ``&[String]``); every y-sample becomes its own contour group."""
    if isinstance(sample_y, str):
        sample_y = [sample_y]
    reader = open_variant_file(calls_path)
    records = reader.records()
    ix = reader.sample_names.index(sample_x)
    iys = {s: reader.sample_names.index(s) for s in sample_y}
    values = []
    for rec in records:
        for s, iy in iys.items():
            try:
                x = float(rec.samples[ix].get("AF", "nan"))
                y = float(rec.samples[iy].get("AF", "nan"))
            except (ValueError, IndexError):
                continue
            if math.isnan(x) or math.isnan(y):
                continue
            values.append(
                {"sample": s, "normal_vaf": x, "tumor_vaf": y}
            )
    if not values:
        raise NoRecordsFoundError()
    return _scatter_contour_blueprint(values, sample_x)
