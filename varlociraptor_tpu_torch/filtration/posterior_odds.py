"""Posterior-odds filtration.

Port of ``src/filtration/posterior_odds.rs:19-82``: keep an
allele unless the Bayes factor of the other events against the target events
reaches the given Kass-Raftery evidence level.
"""

from __future__ import annotations

import math

from ..io.vcf import VcfReader, open_variant_file, VcfWriter, open_variant_writer
from ..utils.logprob import kass_raftery
from .fdr import tags_prob_sum

KR_LEVELS = {"none": 0, "barely": 1, "positive": 2, "strong": 3, "very-strong": 4}


def filter_by_odds(in_vcf, out_vcf, events: list[str], min_evidence: str) -> int:
    reader = open_variant_file(in_vcf)
    records = reader.records()
    min_level = KR_LEVELS[min_evidence.lower().replace("_", "-")]
    event_tags = [f"PROB_{e.upper()}" for e in events]

    # find all PROB_ tags present
    all_tags = set()
    for rec in records:
        for k in rec.info:
            if k.startswith("PROB_"):
                all_tags.add(k)
    other_tags = [t for t in sorted(all_tags) if t not in event_tags]

    n = 0
    with open_variant_writer(
        out_vcf, sample_names=reader.sample_names, header_lines=reader.header_lines
    ) as w:
        for rec in records:
            tp = tags_prob_sum(rec, event_tags)
            op = tags_prob_sum(rec, other_tags)
            if tp is None or op is None:
                continue
            d = op - tp if tp > -math.inf else math.inf
            # exp overflows f64 above ~709 — clamp to +inf like the
            # codebase's other Bayes-factor sites (observation.py, cnvs.py)
            bf = math.inf if d > 700.0 else math.exp(d)
            if kass_raftery(bf) < min_level:
                w.write(rec)
                n += 1
    return n
