"""Haplotype blocks: non-BND variants sharing an EVENT evaluated jointly.

Port of ``src/variants/types/haplotype_block.rs:26-167``:
alt support = product over member variants; ref support via dynamic
programming over "at least one member shows the ref allele"; loci union.
"""

from __future__ import annotations

import numpy as np

from ..utils.logprob import LOG_ZERO, np_ln_add_exp, np_ln_sum_exp
from .extraction import Evidence
from .variants import AlleleSupport, VariantType


def haplotype_support(variant_supports: list[AlleleSupport]) -> AlleleSupport:
    """haplotype_block.rs:115-167."""
    prob_alt = sum(s.prob_alt for s in variant_supports)

    third = None
    for s in variant_supports:
        if s.third_allele_evidence is not None:
            third = (third or 0) + s.third_allele_evidence

    n = len(variant_supports)
    last = [LOG_ZERO] * (n + 1)
    last[0] = 0.0
    for s in variant_supports:
        current = [LOG_ZERO] * (n + 1)
        current[0] = last[0] + s.prob_alt_allele()
        for k in range(1, n + 1):
            current[k] = np_ln_add_exp(
                last[k - 1] + s.prob_ref_allele(), last[k] + s.prob_alt_allele()
            )
        last = current
    prob_ref = np_ln_sum_exp(np.array(last[1:]))

    return AlleleSupport(
        prob_ref=float(prob_ref),
        prob_alt=float(prob_alt),
        strand=variant_supports[0].strand,
        third_allele_evidence=third,
    )


class HaplotypeBlock(VariantType):
    def __init__(self, contig: str, variants: list):
        self.contig = contig
        self.variants = variants
        self.first_pos = min(v.first_pos for v in variants)

    def fetch_intervals(self):
        out = []
        for v in self.variants:
            out.extend(v.fetch_intervals())
        return sorted(out)

    def is_valid_evidence(self, ev: Evidence, props):
        idx = []
        offset = 0
        for v in self.variants:
            sub = v.is_valid_evidence(ev, props)
            if sub is not None:
                idx.extend(offset + i for i in sub)
            offset += len(v.fetch_intervals())
        return idx or None

    def allele_support(self, ev: Evidence, props, alt_variants=()):
        supports = []
        for v in self.variants:
            s = v.allele_support(ev, props, ())
            if s is not None:
                supports.append(s)
        if not supports:
            return None
        return haplotype_support(supports)

    def prob_sample_alt(self, ev: Evidence, props):
        return 0.0  # haplotype_block.rs:105-111
