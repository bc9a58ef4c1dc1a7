"""Variant types: per-type evidence gating and allele support.

Re-designs the reference's ``Variant`` trait family
(``src/variants/types/``) for the tensor pipeline.  Each type
provides host-side evidence gating + either a direct (SNV/MNV fast path) or
realignment-based allele support.  Realignment work items are accumulated and
scored in batch by the JAX pair-HMM kernel (ops.pairhmm) rather than per read.

Implemented here: Snv (snv.rs:38-253), Mnv (mnv.rs:41-359), None/ref-site
(none.rs).  Indel/SV types live in evidence/indels.py (realignment-based).
"""

from __future__ import annotations

import copy

import math
from dataclasses import dataclass

import numpy as np

from ..utils.logprob import LOG_ZERO, PROB_05, np_ln_add_exp
from .extraction import (
    Evidence,
    OVERLAP_ENCLOSING,
    locus_overlap,
)
from .observation import (
    STRAND_BOTH,
    STRAND_FORWARD,
    STRAND_NONE,
    STRAND_REVERSE,
    strand_or,
)

PROB_CONFUSION = math.log(1.0 / 3.0)  # reference uses Prob(0.3333)
PROB_CONFUSION_REF = math.log(0.3333)
PROB_ANY = math.log(0.25)


def prob_read_base_miscall(base_qual: int) -> float:
    """PHRED base quality -> log P(miscall) (bases.rs:29-36)."""
    return -float(base_qual) * math.log(10.0) / 10.0


def prob_read_base(read_base: int, ref_base: int, base_qual: int) -> float:
    """P(read base | true base, qual) with 1/3 confusion (bases.rs:14-26)."""
    rb = read_base & ~0x20  # uppercase ASCII
    tb = ref_base & ~0x20
    if rb == tb:
        return np_ln_one_minus_exp_scalar(prob_read_base_miscall(base_qual))
    if rb == ord("N"):
        return PROB_ANY
    return prob_read_base_miscall(base_qual) + PROB_CONFUSION_REF


def np_ln_one_minus_exp_scalar(x: float) -> float:
    if x >= 0.0:
        return LOG_ZERO
    if x < -math.log(2.0):
        return math.log1p(-math.exp(x))
    return math.log(-math.expm1(x))


@dataclass
class AlleleSupport:
    """types/mod.rs:55-155."""

    prob_ref: float
    prob_alt: float
    strand: int = STRAND_NONE
    read_position: int | None = None
    homopolymer_indel_len: int | None = None
    third_allele_evidence: int | None = None

    def _both_impossible(self):
        return self.prob_ref == LOG_ZERO and self.prob_alt == LOG_ZERO

    def prob_ref_allele(self):
        return PROB_05 if self._both_impossible() else self.prob_ref

    def prob_alt_allele(self):
        return PROB_05 if self._both_impossible() else self.prob_alt

    def is_alt_support(self):
        return self.prob_alt > self.prob_ref

    def prob_missed_allele(self):
        return np_ln_add_exp(self.prob_ref_allele(), self.prob_alt_allele()) - math.log(2.0)

    def clone(self) -> "AlleleSupport":
        # hand-rolled shallow copy: the fast-path record cache returns a
        # fresh instance per caller (merge() mutates); copy.copy costs ~5x
        # a direct constructor call in the per-read hot loop
        return AlleleSupport(
            prob_ref=self.prob_ref,
            prob_alt=self.prob_alt,
            strand=self.strand,
            read_position=self.read_position,
            homopolymer_indel_len=self.homopolymer_indel_len,
            third_allele_evidence=self.third_allele_evidence,
        )

    def merge(self, other: "AlleleSupport"):
        """types/mod.rs:104-155."""
        if self.is_alt_support():
            if other.is_alt_support() and self.read_position != other.read_position:
                self.read_position = None
        elif other.is_alt_support():
            self.read_position = other.read_position

        self.prob_ref += other.prob_ref
        self.prob_alt += other.prob_alt

        if self.strand == STRAND_NONE:
            self.strand = other.strand
            self.homopolymer_indel_len = other.homopolymer_indel_len
        elif other.strand != STRAND_NONE:
            self.strand = strand_or(self.strand, other.strand)
            if self.homopolymer_indel_len is None:
                self.homopolymer_indel_len = other.homopolymer_indel_len

        if other.third_allele_evidence is not None:
            if self.third_allele_evidence is None:
                self.third_allele_evidence = other.third_allele_evidence
            else:
                self.third_allele_evidence = min(
                    self.third_allele_evidence, other.third_allele_evidence
                )
        return self


def strand_from_record(record, qpos: int | None = None) -> int:
    """Strand::from_record_and_pos (read_observation.rs:60-110):
    per-base SI aux tag wins, else global FLAG strand."""
    si = record.tags.get("SI")
    if isinstance(si, str) and qpos is not None and qpos < len(si):
        c = si[qpos]
        return {"+": STRAND_FORWARD, "-": STRAND_REVERSE, "*": 3, ".": 0}.get(c, 0)
    return STRAND_REVERSE if record.is_reverse else STRAND_FORWARD


class VariantType:
    """Base protocol for variant types (host side)."""

    contig: str
    first_pos: int
    is_imprecise: bool = False
    uses_read_pair_window: bool = False

    def fetch_intervals(self):
        raise NotImplementedError

    def is_valid_evidence(self, ev: Evidence, props):
        raise NotImplementedError

    def allele_support(self, ev: Evidence, props, alt_variants):
        raise NotImplementedError

    def prob_sample_alt(self, ev: Evidence, props) -> float:
        return 0.0  # ln(1)

    def homopolymer_error_model(self, props):
        return None

    def scout_relevant(self, ev: Evidence) -> bool:
        """True when allele_support(ev) could queue a pair-HMM forward —
        the scout pass (extraction.extract_observations_begin) exists only
        to enumerate forward requests, so evidence that provably takes the
        direct fast path is skipped there (it is evaluated once, in the
        replay pass). Default: conservatively True."""
        return True


class Snv(VariantType):
    """SNV with the direct base-comparison fast path (snv.rs:66-150).

    Reads with indel CIGAR ops are flagged for realignment; until the
    realignment kernel path is wired in (ops.pairhmm), they fall back to the
    direct comparison which is correct for reads whose CIGAR places the locus.
    """

    def __init__(self, contig: str, pos: int, ref_base: int, alt_base: int, realigner=None, realign_indel_reads: bool = True):
        self.contig = contig
        self.pos = pos
        self.first_pos = pos
        self.ref_base = ref_base & ~0x20
        self.alt_base = alt_base & ~0x20
        self.realigner = realigner
        self.realign_indel_reads = realign_indel_reads

    def fetch_intervals(self):
        return [(self.pos, self.pos + 1)]

    def is_valid_evidence(self, ev: Evidence, props):
        # ENCLOSING overlap of [pos, pos+1) with no clips/offsets reduces
        # to two int comparisons on the cached record spans
        p = self.pos
        for s, e in ev.bounds():
            if s <= p < e:
                return [0]
        return None

    def alt_emission_params(self, ref_seq, region_start, region_end, ref_window):
        """SnvEmissionParams (snv.rs:157-179): ref window with the alt base
        substituted at the SNV position."""
        from .realignment import AlleleEmission

        start = self.pos
        ref_offset = max(0, start - ref_window)
        ref_end = min(start + 1 + ref_window, len(ref_seq))
        seq = bytearray(ref_seq[ref_offset:ref_end])
        seq[start - ref_offset] = self.alt_base
        return [
            AlleleEmission(
                seq=bytes(seq),
                ref_offset=ref_offset,
                variant_ref_range=(start, start + 1),
            )
        ]

    def scout_relevant(self, ev):
        # forwards are queued only for reads routed to the realigner
        # (_support_per_read's indel-operations gate); pure fast-path
        # evidence is skipped in the scout pass
        if not self.realign_indel_reads or self.realigner is None:
            return False
        return any(r.has_indel_operations() for r in ev.records())

    def _support_per_read(self, record, props, alt_variants):
        # ENCLOSING of [pos, pos+1), no clips/offsets: two int compares
        if not (record.pos <= self.pos < record.end_pos):
            return None
        if (
            self.realign_indel_reads
            and self.realigner is not None
            and record.has_indel_operations()
        ):
            return self.realigner.allele_support(
                record, [(self.pos, self.pos + 1)], self, alt_variants, props
            )
        # the fast path below is a pure function of (variant, record); the
        # scout and replay passes evaluate it twice per read — cache the
        # latest (variant, result) on the record (single slot: passes visit
        # a record's loci back-to-back). Callers mutate supports via
        # merge(), so cache hits return a shallow copy.
        slot = getattr(record, "_vlt_fastsup", None)
        if slot is not None and slot[0] is self:
            return None if slot[1] is None else slot[1].clone()
        sup = self._fast_support(record, props)
        object.__setattr__(record, "_vlt_fastsup", (self, sup))
        return None if sup is None else sup.clone()

    def _fast_support(self, record, props):
        qpos = record.read_pos(self.pos)
        if qpos is None:
            # locus deleted/skipped in this read: no observation (snv.rs:144-149)
            return None
        read_base = int(record.seq[qpos]) & ~0x20
        base_qual = int(record.qual[qpos])
        prob_alt = prob_read_base(read_base, self.alt_base, base_qual)
        is_third_allele = False
        # non-alt base as ref for multiallelic fairness (snv.rs:99-114)
        if read_base != ord("N") and read_base != self.alt_base:
            is_third_allele = read_base != self.ref_base
            non_alt_base = read_base
        else:
            non_alt_base = self.ref_base
        prob_ref = prob_read_base(read_base, non_alt_base, base_qual)
        if prob_ref != prob_alt:
            strand = strand_from_record(record, qpos)
        else:
            strand = STRAND_NONE
        # hardclips are part of the original read (snv.rs:130-135)
        from ..io.bam import OP_H

        leading_hard = (
            int(record.cigar[0][1])
            if len(record.cigar) and record.cigar[0][0] == OP_H
            else 0
        )
        return AlleleSupport(
            prob_ref=prob_ref,
            prob_alt=prob_alt,
            strand=strand,
            read_position=qpos + leading_hard,
            third_allele_evidence=1 if is_third_allele else None,
        )

    def allele_support(self, ev: Evidence, props, alt_variants=()):
        supports = [
            s
            for s in (
                self._support_per_read(r, props, alt_variants) for r in ev.records()
            )
            if s is not None
        ]
        if not supports:
            return None
        out = supports[0]
        for s in supports[1:]:
            out.merge(s)
        return out


def snv_vector_observations(variant, evs, props):
    """Vectorized SNV fast-path observation extraction for a pileup.

    Returns ``(obs_by_idx, bail_idx)``: ``obs_by_idx[i]`` is the
    ReadObservation (or None = dropped) for ``evs[i]`` when the vector path
    handled it; indices in ``bail_idx`` must go through the scalar
    scout/replay path (non-simple cigars, SI per-base strand tags,
    indel-op reads routed to the realigner).

    Exactly replays ``Snv._fast_support`` + ``AlleleSupport.merge`` +
    ``evidence_to_observation`` semantics (snv.rs:66-150,
    read_observation.rs:626-701) with the per-read probability math done
    once per pileup in numpy; per-fragment invariants (prob_mapping,
    orientation, lengths) come from the Evidence caches."""
    import numpy as _np

    from ..utils.logprob import np_ln_one_minus_exp
    from .observation import ReadObservation

    p = variant.pos
    realign = variant.realign_indel_reads and variant.realigner is not None
    bail_idx = []
    # flat per-record collection
    ev_first = []  # record row index of ev's first support, -1 = none
    ev_second = []
    rows_base = []
    rows_qual = []
    rows_rev = []
    rows_qpos = []
    handled_idx = []
    for i, ev in enumerate(evs):
        rows = []
        ok = True
        for rec in ev.records():
            if not (rec.pos <= p < rec.end_pos):
                continue
            simple = getattr(rec, "_vlt_simple", None)
            if simple is None:
                simple = (
                    len(rec.cigar) == 1 and rec.cigar[0][0] in (0, 7, 8)
                )
                object.__setattr__(rec, "_vlt_simple", simple)
            if (
                not simple
                or "SI" in rec.tags
                or (realign and rec.has_indel_operations())
            ):
                ok = False
                break
            qpos = p - rec.pos
            rows.append(
                (
                    int(rec.seq[qpos]) & ~0x20,
                    int(rec.qual[qpos]),
                    rec.is_reverse,
                    qpos,
                )
            )
        if not ok:
            bail_idx.append(i)
            continue
        handled_idx.append(i)
        base = len(rows_base)
        ev_first.append(base if rows else -1)
        ev_second.append(base + 1 if len(rows) == 2 else -1)
        for b, q, r, qp in rows:
            rows_base.append(b)
            rows_qual.append(q)
            rows_rev.append(r)
            rows_qpos.append(qp)

    obs_by_idx: dict = {}
    if not handled_idx:
        return obs_by_idx, bail_idx

    n_rows = len(rows_base)
    if n_rows:
        base = _np.asarray(rows_base, dtype=_np.int64)
        qual = _np.asarray(rows_qual, dtype=_np.float64)
        rev = _np.asarray(rows_rev, dtype=bool)
        miscall = -qual * (math.log(10.0) / 10.0)
        match_p = np_ln_one_minus_exp(miscall)
        mis_p = miscall + PROB_CONFUSION_REF
        is_n = base == ord("N")
        is_alt = base == variant.alt_base
        third = (~is_n) & (~is_alt) & (base != variant.ref_base)
        pa = _np.where(is_alt, match_p, _np.where(is_n, PROB_ANY, mis_p))
        # prob vs the non-alt base (the read's own base for third alleles)
        pr = _np.where(
            third, match_p,
            _np.where(is_n, PROB_ANY, _np.where(is_alt, mis_p, match_p)),
        )
        strand = _np.where(
            pr != pa,
            _np.where(rev, STRAND_REVERSE, STRAND_FORWARD),
            STRAND_NONE,
        )
        alt_sup = pa > pr
        qpos_a = _np.asarray(rows_qpos, dtype=_np.int64)

    f = _np.asarray(ev_first, dtype=_np.int64)
    s = _np.asarray(ev_second, dtype=_np.int64)
    has_f = f >= 0
    has_s = s >= 0
    fz = _np.maximum(f, 0)
    sz = _np.maximum(s, 0)
    if n_rows:
        pa_ev = _np.where(has_f, pa[fz], 0.0) + _np.where(has_s, pa[sz], 0.0)
        pr_ev = _np.where(has_f, pr[fz], 0.0) + _np.where(has_s, pr[sz], 0.0)
        st_ev = (
            _np.where(has_f, strand[fz], 0) | _np.where(has_s, strand[sz], 0)
        )
        third_ev = _np.where(has_f, third[fz], False) | _np.where(
            has_s, third[sz], False
        )
        # log(exp(pr)+exp(pa)) - log 2, elementwise -inf-safe
        m = _np.maximum(pr_ev, pa_ev)
        pm_missed = (
            m
            + _np.log1p(_np.exp(_np.minimum(pr_ev, pa_ev) - m))
            - math.log(2.0)
        )
    ln10_10 = math.log(10.0) / 10.0
    for k, i in enumerate(handled_idx):
        ev = evs[i]
        if not has_f[k]:
            obs_by_idx[i] = None  # no overlapping record: no support
            continue
        st = int(st_ev[k])
        if st == STRAND_NONE:
            obs_by_idx[i] = None  # uninformative read (precise variant)
            continue
        # read_position merge (types/mod.rs:104-155)
        a1 = bool(alt_sup[fz[k]])
        rp = int(qpos_a[fz[k]])
        if has_s[k]:
            a2 = bool(alt_sup[sz[k]])
            rp2 = int(qpos_a[sz[k]])
            if a1:
                if a2 and rp2 != rp:
                    rp = None
            elif a2:
                rp = rp2
        o = ReadObservation(name=ev.qname())
        pm = ev.prob_mapping()
        o.prob_mapping = pm
        o.prob_mismapping = np_ln_one_minus_exp(pm)
        o.prob_alt = float(pa_ev[k])
        o.prob_ref = float(pr_ev[k])
        o.prob_missed_allele = float(pm_missed[k])
        o.prob_sample_alt = 0.0
        if st == STRAND_BOTH:
            o.prob_double_overlap = 0.0
            o.prob_single_overlap = LOG_ZERO
        else:
            o.prob_double_overlap = LOG_ZERO
            o.prob_single_overlap = 0.0
        o.strand = st
        o.read_orientation = ev.read_orientation()
        o.softclipped = ev.softclipped()
        o.read_position_raw = rp
        o.paired = ev.is_paired()
        tl = ev.total_len()
        o.prob_hit_base = -math.log(tl) if tl > 0 else LOG_ZERO
        o.is_max_mapq = ev.min_mapq() == props.max_mapq
        o.alt_loci_raw = ev.alt_loci()
        o.third_allele_evidence = 1 if third_ev[k] else None
        o.homopolymer_indel_len = None
        o.prob_observable_at_homopolymer_artifact = None
        o.prob_observable_at_homopolymer_variant = None
        obs_by_idx[i] = o
    return obs_by_idx, bail_idx


class Mnv(VariantType):
    """Multi-nucleotide variant: product of per-base probs over the window
    (mnv.rs:41-359)."""

    def __init__(self, contig: str, pos: int, ref_bases, alt_bases, realigner=None, realign_indel_reads: bool = True):
        self.contig = contig
        self.pos = pos
        self.first_pos = pos
        self.ref_bases = bytes(b & ~0x20 for b in ref_bases)
        self.alt_bases = bytes(b & ~0x20 for b in alt_bases)
        self.len = len(self.alt_bases)
        self.realigner = realigner
        self.realign_indel_reads = realign_indel_reads

    def fetch_intervals(self):
        return [(self.pos, self.pos + self.len)]

    def is_valid_evidence(self, ev: Evidence, props):
        p, q = self.pos, self.pos + self.len
        for s, e in ev.bounds():
            if s <= p and e >= q:
                return [0]
        return None

    def alt_emission_params(self, ref_seq, region_start, region_end, ref_window):
        """MNV emission: alt bases spliced over the window (mnv.rs)."""
        from .realignment import AlleleEmission

        start = self.pos
        ref_offset = max(0, start - ref_window)
        ref_end = min(start + self.len + ref_window, len(ref_seq))
        seq = bytearray(ref_seq[ref_offset:ref_end])
        for i, b in enumerate(self.alt_bases):
            seq[start - ref_offset + i] = b
        return [
            AlleleEmission(
                seq=bytes(seq),
                ref_offset=ref_offset,
                variant_ref_range=(start, start + self.len),
            )
        ]

    def scout_relevant(self, ev):
        # forwards are queued only for reads routed to the realigner
        # (_support_per_read's indel-operations gate); pure fast-path
        # evidence is skipped in the scout pass
        if not self.realign_indel_reads or self.realigner is None:
            return False
        return any(r.has_indel_operations() for r in ev.records())

    def _support_per_read(self, record, props, alt_variants):
        if locus_overlap(record, self.pos, self.pos + self.len) != OVERLAP_ENCLOSING:
            return None
        if (
            self.realign_indel_reads
            and self.realigner is not None
            and record.has_indel_operations()
        ):
            return self.realigner.allele_support(
                record, [(self.pos, self.pos + self.len)], self, alt_variants, props
            )
        slot = getattr(record, "_vlt_fastsup", None)
        if slot is not None and slot[0] is self:
            return None if slot[1] is None else slot[1].clone()
        sup = self._fast_support(record, props)
        object.__setattr__(record, "_vlt_fastsup", (self, sup))
        return None if sup is None else sup.clone()

    def _fast_support(self, record, props):
        # mnv.rs:95-200: true-ref per-base product, plus a third-allele
        # rescue — if the read prefers ALT but differs from ALT by more
        # substitutions than the error rate explains, contrast against an
        # allele derived from the read itself (prob_third).
        prob_ref = 0.0
        prob_alt = 0.0
        prob_third = 0.0
        alt_edit_dist = 0
        n_ref_matching_mismatch = 0
        first_qpos = None
        for i in range(self.len):
            qpos = record.read_pos(self.pos + i)
            if qpos is None:
                return None
            if first_qpos is None:
                first_qpos = qpos
            read_base = int(record.seq[qpos]) & ~0x20
            qual = int(record.qual[qpos])
            if read_base != ord("N") and read_base != self.alt_bases[i]:
                alt_edit_dist += 1
                # rescue evidence: the mismatched base is trustworthy —
                # either it matches the ref allele (ref/alt mosaic) or it
                # is a confidently-called novel base (q >= 20); a low-qual
                # novel base is just a miscall
                if read_base == self.ref_bases[i] or qual >= 20:
                    n_ref_matching_mismatch += 1
            prob_alt += prob_read_base(read_base, self.alt_bases[i], qual)
            prob_ref += prob_read_base(read_base, self.ref_bases[i], qual)
            prob_third += prob_read_base(read_base, read_base, qual)
        is_third_allele = False
        # Third-allele rescue (mnv.rs:164-181) with a recombinant gate:
        # only rescue when at least one mismatch-vs-alt MATCHES the ref
        # base — the read then looks like a ref/alt mosaic (chimera,
        # misprimed fragment, partial MNV), which is third-allele
        # evidence. A novel base matching neither allele is far likelier
        # a plain sequencing miscall (its ref/alt likelihood contribution
        # already reflects that), and rescuing it would flip clean hom
        # calls on a single noisy base (reference behavior on test38).
        if (
            prob_alt > prob_ref
            and alt_edit_dist > 0
            and n_ref_matching_mismatch > 0
        ):
            from ..evidence.edit_distance import is_explainable_by_error_rates

            quals = record.qual.astype(np.float64)
            miscalls = -quals * math.log(10.0) / 10.0
            error_rate = float(
                np.log(np.sum(np.exp(miscalls))) - math.log(max(record.read_len, 1))
            )
            if not is_explainable_by_error_rates(
                alt_edit_dist, 0, 0, self.len, props, error_rate
            ):
                prob_ref = prob_third
                is_third_allele = True
        strand = (
            strand_from_record(record, first_qpos)
            if prob_ref != prob_alt
            else STRAND_NONE
        )
        return AlleleSupport(
            prob_ref=prob_ref,
            prob_alt=prob_alt,
            strand=strand,
            read_position=first_qpos,
            third_allele_evidence=alt_edit_dist if is_third_allele else None,
        )

    def allele_support(self, ev: Evidence, props, alt_variants=()):
        supports = [
            s
            for s in (
                self._support_per_read(r, props, alt_variants) for r in ev.records()
            )
            if s is not None
        ]
        if not supports:
            return None
        out = supports[0]
        for s in supports[1:]:
            out.merge(s)
        return out


class RefSite(VariantType):
    """`None` variant (`<*>` dummy alt): hom-ref testing (none.rs).

    prob_ref = P(read base == ref base); prob_alt = P(read base is any
    non-ref base) with the confusion model.
    """

    def __init__(self, contig: str, pos: int, ref_base: int):
        self.contig = contig
        self.pos = pos
        self.first_pos = pos
        self.ref_base = ref_base & ~0x20

    def fetch_intervals(self):
        return [(self.pos, self.pos + 1)]

    def is_valid_evidence(self, ev: Evidence, props):
        # ENCLOSING overlap of [pos, pos+1) with no clips/offsets reduces
        # to two int comparisons on the cached record spans
        p = self.pos
        for s, e in ev.bounds():
            if s <= p < e:
                return [0]
        return None

    def _support_per_read(self, record, props):
        # ENCLOSING of [pos, pos+1), no clips/offsets: two int compares
        if not (record.pos <= self.pos < record.end_pos):
            return None
        qpos = record.read_pos(self.pos)
        if qpos is None:
            return None
        read_base = int(record.seq[qpos]) & ~0x20
        qual = int(record.qual[qpos])
        prob_ref = prob_read_base(read_base, self.ref_base, qual)
        # alt = any other base: if read matches ref, alt likelihood is a
        # miscall; otherwise the read base itself is the evidence.
        if read_base == self.ref_base:
            prob_alt = prob_read_base_miscall(qual) + PROB_CONFUSION_REF
        else:
            prob_alt = prob_read_base(read_base, read_base, qual)
        strand = strand_from_record(record, qpos) if prob_ref != prob_alt else STRAND_NONE
        return AlleleSupport(
            prob_ref=prob_ref, prob_alt=prob_alt, strand=strand, read_position=qpos
        )

    def allele_support(self, ev: Evidence, props, alt_variants=()):
        supports = [
            s for s in (self._support_per_read(r, props) for r in ev.records()) if s is not None
        ]
        if not supports:
            return None
        out = supports[0]
        for s in supports[1:]:
            out.merge(s)
        return out
