"""Tumor mutational burden estimation.

Port of ``src/estimation/mutational_burden.rs:18-362``:
expected mutations-per-megabase above VAF cutoffs from annotated calls,
stratified by mutational signature, as a vega-lite JSON spec (curve /
hist / multibar) or a TSV table.  Faithful semantics:

- records must carry a VEP/snpEff ``ANN`` INFO field and at least one
  annotation with field 7 == ``protein_coding`` and a non-empty field 13
  (``is_valid_variant``, mutational_burden.rs:18-43); records without ANN
  are skipped with a warning,
- per-alt-allele signature classification (``signatures``,
  mutational_burden.rs:482-516): symbolic alleles -> DEL/INV/DUP/BND/METH,
  SNVs -> substitution class (e.g. ``C>T``), length-based DEL/INS/MNV,
  else COMPLEX,
- multiple samples contribute independently; the multibar mode groups by
  (signature, sample) at the VAF cutoff (mutational_burden.rs:217-247).
"""

from __future__ import annotations

import logging
import math

import numpy as np

from ..io.vcf import open_variant_file
from ..utils.logprob import np_log_from_phred

log = logging.getLogger("varlociraptor_tpu_torch.tmb")

_SYMBOLIC = {
    "<DEL>": "DEL",
    "<INV>": "INV",
    "<DUP>": "DUP",
    "<BND>": "BND",
    "<METH>": "METH",
}


def signature(ref: str, alt: str) -> str:
    """Per-alt signature (mutational_burden.rs:482-516)."""
    s = _SYMBOLIC.get(alt)
    if s is not None:
        return s
    if len(ref) == 1 and len(alt) == 1:
        return f"{ref.upper()}>{alt.upper()}"
    if len(ref) > 1 and len(alt) == 1:
        return "DEL"
    if len(ref) == 1 and len(alt) > 1:
        return "INS"
    if len(ref) == len(alt) and len(ref) > 1:
        return "MNV"
    return "COMPLEX"


def is_coding(rec) -> bool:
    """is_valid_variant (mutational_burden.rs:18-43): at least one ANN
    entry with field 7 == protein_coding and non-empty field 13."""
    ann = rec.info_get("ANN")
    if ann is None or ann is True:
        log.warning("No ANN field found in record at %s:%d.", rec.chrom, rec.pos + 1)
        return False
    for entry in str(ann).split(","):
        fields = entry.split("|")
        if (
            len(fields) > 13
            and fields[7] == "protein_coding"
            and fields[13] != ""
        ):
            return True
    return False


def _collect_records(calls_path, events, sample_names):
    """-> list of (vaf, prob_linear_log, signature, sample)."""
    reader = open_variant_file(calls_path)
    records = reader.records()  # parses the header: sample_names valid after
    idx = {}
    for s in sample_names:
        try:
            idx[s] = reader.sample_names.index(s)
        except ValueError:
            raise ValueError(f"sample {s} not in calls") from None
    tags = [f"PROB_{e.upper()}" for e in events]
    rows = []
    for rec in records:
        if not is_coding(rec):
            continue
        sigs = [signature(rec.ref, a) for a in rec.alts]
        # sum the event probabilities per alt allele; a record missing any
        # required tag is skipped entirely (mutational_burden.rs:140-156)
        allele_probs = [-math.inf] * len(sigs)
        ok = True
        for tag in tags:
            raw = rec.info_get(tag)
            if raw is None or raw is True:
                ok = False
                break
            vals = str(raw).split(",")
            for i in range(len(sigs)):
                try:
                    p = np_log_from_phred(float(vals[min(i, len(vals) - 1)]))
                except ValueError:
                    continue
                allele_probs[i] = np.logaddexp(allele_probs[i], p)
        if not ok:
            continue
        for name, si in idx.items():
            try:
                afs = str(rec.samples[si].get("AF", "nan")).split(",")
            except IndexError:
                continue
            for i, sig in enumerate(sigs):
                try:
                    vaf = float(afs[min(i, len(afs) - 1)])
                except ValueError:
                    continue
                if vaf != vaf:
                    continue
                rows.append((vaf, float(allele_probs[i]), sig, name))
    return rows


def _mb(probs, coding_genome_size):
    if not probs:
        return 0.0
    count = math.exp(np.logaddexp.reduce(np.array(probs)))
    return count / coding_genome_size * 1e6


def collect_estimates(
    calls_path,
    events: list[str],
    sample,
    coding_genome_size: float = 3e7,
    mode: str = "curve",
    cutoff: float = 0.2,
):
    sample_names = [sample] if isinstance(sample, str) else list(sample)
    rows = _collect_records(calls_path, events, sample_names)
    if not rows:
        raise ValueError("no valid (coding, annotated) records found")

    sigs = sorted({r[2] for r in rows})
    min_vafs = np.linspace(0.0, 1.0, 100)

    if mode == "multibar":
        # TMB at the cutoff, grouped by (signature, sample)
        # (mutational_burden.rs:217-247)
        data = []
        for name in sample_names:
            for sig in sigs:
                probs = [
                    p for v, p, s, n in rows
                    if n == name and s == sig and cutoff <= v < 1.0
                ]
                if probs:
                    data.append(
                        {
                            "vaf": cutoff,
                            "tmb": _mb(probs, coding_genome_size),
                            "vartype": sig,
                            "sample": name,
                        }
                    )
        return _spec(data, "bar")

    if mode == "table":
        # TSV (min_vaf, tmb, vartype) over 100 cutoffs
        # (mutational_burden.rs:324-347)
        out = ["min_vaf\ttmb\tvartype"]
        for v in min_vafs:
            for sig in sigs:
                probs = [p for vv, p, s, _ in rows if s == sig and vv >= v]
                if probs:
                    out.append(
                        f"{v:.6f}\t{_mb(probs, coding_genome_size):.6f}\t{sig}"
                    )
        return {"table": "\n".join(out)}

    if mode == "hist":
        # 19 bin centers, +-0.05 windows, per signature
        # (mutational_burden.rs:249-288)
        data = []
        for center in np.linspace(0.05, 0.95, 19):
            for sig in sigs:
                probs = [
                    p for v, p, s, _ in rows
                    if s == sig and center - 0.05 <= v < center + 0.05
                ]
                if probs:
                    data.append(
                        {
                            "vaf": float(center),
                            "tmb": _mb(probs, coding_genome_size),
                            "vartype": sig,
                        }
                    )
        return _spec(data, "bar")

    # curve (cumulative, stratified by signature,
    # mutational_burden.rs:290-322)
    data = []
    for v in min_vafs:
        for sig in sigs:
            probs = [p for vv, p, s, _ in rows if s == sig and vv >= v]
            if probs:
                data.append(
                    {
                        "vaf": float(v),
                        "tmb": _mb(probs, coding_genome_size),
                        "vartype": sig,
                    }
                )
    return _spec(data, "line")


def _spec(data, mark):
    return {
        "$schema": "https://vega.github.io/schema/vega-lite/v4.json",
        "data": {"values": data},
        "mark": mark,
        "encoding": {
            "x": {"field": "vaf", "type": "quantitative", "title": "VAF cutoff"},
            "y": {
                "field": "tmb",
                "type": "quantitative",
                "title": "mutations per megabase",
            },
            "color": {"field": "vartype", "type": "nominal"},
        },
    }
