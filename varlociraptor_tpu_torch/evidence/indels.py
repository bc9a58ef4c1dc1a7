"""Realignment-based variant types: deletion, insertion, inversion,
duplication, replacement.

Ports the per-type mechanics from ``src/variants/types/``:
- ``Deletion`` (deletion.rs): spliced-ref alt emission, paired-end insert-size
  likelihood term, fragment-must-enclose-centerpoint evidence rule,
  homopolymer detection, fragment sampling bias.
- ``Insertion`` (insertion.rs): insert-spliced emission, independent-read
  sampling bias, homopolymer detection.
- ``Inversion``/``Duplication`` (inversion.rs/duplication.rs): in the
  reference these delegate to an internal breakend group; here the alt allele
  (revcomp'd / tandem-duplicated segment) is constructed directly.
- ``Replacement`` (replacement.rs): arbitrary REF->ALT block substitution.

Insert-size model: discretized Gaussian pmf (fragments.rs:164-166) via
``math.erf`` (replacing GSL ``ugaussian_P``).
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.logprob import LOG_ZERO, NUMERICAL_EPSILON, np_ln_sum_exp
from .extraction import Evidence, locus_overlap
from .observation import STRAND_NONE
from .realignment import AlleleEmission, Realigner
from .variants import AlleleSupport, VariantType

REVCOMP = {65: 84, 84: 65, 67: 71, 71: 67, 78: 78}  # A<->T C<->G N


def revcomp(seq: np.ndarray) -> bytes:
    return bytes(REVCOMP.get(int(b) & ~0x20, 78) for b in seq[::-1])


def _ugaussian_p(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def isize_pmf(value, mean, sd):
    """Discretized Gaussian pmf (fragments.rs:164-166)."""
    p = _ugaussian_p((value + 0.5 - mean) / sd) - _ugaussian_p((value - 0.5 - mean) / sd)
    return math.log(p) if p > 0 else LOG_ZERO


def estimate_insert_size(left, right):
    """Seemann-style insert size incl. clips (insert_size.rs:17-45)."""

    def aln(rec):
        lead = rec.leading_softclips() + _leading_hardclips(rec)
        trail = rec.trailing_softclips() + _trailing_hardclips(rec)
        return max(0, rec.pos - lead), rec.end_pos + trail

    ls, le = aln(left)
    rs, re = aln(right)
    inner = rs - le
    insert = inner + (le - ls) + (re - rs)
    return max(insert, 0)


def _leading_hardclips(rec):
    from ..io.bam import OP_H

    return int(rec.cigar[0][1]) if len(rec.cigar) and rec.cigar[0][0] == OP_H else 0


def _trailing_hardclips(rec):
    from ..io.bam import OP_H

    return int(rec.cigar[-1][1]) if len(rec.cigar) and rec.cigar[-1][0] == OP_H else 0


def is_homopolymer_seq(seq: bytes) -> bool:
    return len(seq) > 0 and len(set(seq.upper())) == 1


def extend_homopolymer_stretch(base: int, seq) -> int:
    n = 0
    b = base & ~0x20
    for c in seq:
        if (int(c) & ~0x20) == b:
            n += 1
        else:
            break
    return n


class RealignedVariant(VariantType):
    """Common machinery for realignment-based types."""

    def __init__(self, contig, realigner: Realigner):
        self.contig = contig
        self.realigner = realigner

    # subclasses define: realign_loci() -> [(start,end)], alt_emission_params,
    # enclosable_len, feasible_bases

    def _support_read(self, record, props, alt_variants):
        return self.realigner.allele_support(
            record, self.realign_loci(), self, alt_variants, props
        )

    def allele_support(self, ev: Evidence, props, alt_variants=()):
        supports = [self._support_read(r, props, alt_variants) for r in ev.records()]
        out = supports[0]
        for s in supports[1:]:
            out.merge(s)
        return out

    # ---- sampling bias (sampling_bias/{mod,reads}.rs) ------------------
    def feasible_bases(self, read_len, props):
        if props.frac_max_softclip is not None:
            return int(read_len * props.frac_max_softclip)
        return None

    def enclosable_len(self):
        return None

    def prob_sample_alt_read(self, read_len, props):
        feasible = self.feasible_bases(read_len, props)
        if feasible is None:
            return 0.0
        el = self.enclosable_len()
        n_alt = min(el, read_len) if el is not None else read_len
        n_alt_valid = min(n_alt, feasible)
        return math.log(n_alt_valid) - math.log(n_alt) if n_alt > 0 else 0.0

    def prob_sample_alt(self, ev: Evidence, props):
        # default: independent reads (insertion.rs:206-227)
        if ev.is_paired_evidence:
            a = self.prob_sample_alt_read(ev.left.read_len, props)
            b = self.prob_sample_alt_read(ev.right.read_len, props)
            return _ln1m(_ln1m(a) + _ln1m(b))
        return self.prob_sample_alt_read(ev.left.read_len, props)


def _ln1m(x):
    if x >= 0.0:
        return LOG_ZERO
    if x < -math.log(2.0):
        return math.log1p(-math.exp(x))
    return math.log(-math.expm1(x))


class Deletion(RealignedVariant):
    uses_read_pair_window = True

    def __init__(self, contig, start, length, realigner):
        super().__init__(contig, realigner)
        self.start = start
        self.first_pos = start
        self.len = int(length)
        self.end = start + self.len
        self.centerpoint = start + int(round(self.len / 2.0))
        ref_seq = realigner.reference.seq(contig)
        del_seq = bytes(ref_seq[start + 1 : self.end + 1])
        self.homopolymer = None
        if is_homopolymer_seq(del_seq):
            hstart = (
                start
                + 1
                - extend_homopolymer_stretch(del_seq[0], ref_seq[: start + 1][::-1])
            )
            hend = self.end + 1 + extend_homopolymer_stretch(
                del_seq[0], ref_seq[self.end + 1 :]
            )
            if hend - hstart > 1:
                self.homopolymer = (hstart, hend)

    def realign_loci(self):
        return [(self.start, self.end)]

    def fetch_intervals(self):
        # deletion.rs:69-77: start, centerpoint, end
        return [
            (self.start, self.start + 1),
            (self.centerpoint, self.centerpoint + 1),
            (self.end - 1, self.end),
        ]

    def homopolymer_error_model(self, props):
        if self.homopolymer is None:
            return None
        return HomopolymerErrorModel(-self.len, props)

    def is_valid_evidence(self, ev: Evidence, props):
        # deletion.rs:158-197
        if not ev.is_paired_evidence:
            if locus_overlap(ev.left, self.start, self.end, True) != 0:
                return [0, 1, 2]
            return None
        if props.insert_size is not None:
            encloses = (
                ev.left.pos < self.centerpoint and ev.right.end_pos > self.centerpoint
            )
            if encloses and (
                locus_overlap(ev.left, self.start, self.end, True) != 0
                or locus_overlap(ev.right, self.start, self.end, True) != 0
            ):
                return [0, 1, 2]
            return None
        if (
            locus_overlap(ev.left, self.start, self.end, True) != 0
            or locus_overlap(ev.right, self.start, self.end, True) != 0
        ):
            return [0, 1, 2]
        return None

    def alt_emission_params(self, ref_seq, region_start, region_end, ref_window):
        # deletion.rs:302-349
        start = self.start
        ref_offset = max(0, start - ref_window)
        ref_end = min(start + ref_window, len(ref_seq) - self.len)
        seq = bytes(ref_seq[ref_offset : start + 1]) + bytes(
            ref_seq[start + 1 + self.len : ref_end + self.len]
        )
        return [
            AlleleEmission(
                seq=seq,
                ref_offset=ref_offset,
                variant_ref_range=(start, start + self.len),
                homopolymer_ref_range=self.homopolymer,
                alt_vs_ref_len_diff=-self.len,
            )
        ]

    def allele_support(self, ev: Evidence, props, alt_variants=()):
        support = super().allele_support(ev, props, alt_variants)
        if ev.is_paired_evidence and props.insert_size is not None:
            isize_support = self._allele_support_isize(ev.left, ev.right, props)
            support.merge(isize_support)
        return support

    def _allele_support_isize(self, left, right, props):
        """types/mod.rs:197-245 (IsizeObservable)."""
        insert_size = estimate_insert_size(left, right)
        p_ref = isize_pmf(insert_size, props.insert_size.mean, props.insert_size.sd)
        p_alt = isize_pmf(
            insert_size, props.insert_size.mean + self.len, props.insert_size.sd
        )

        def within_sd(shift):
            return (
                abs(insert_size - (props.insert_size.mean + shift))
                <= props.insert_size.sd
            )

        if (p_ref == LOG_ZERO and not within_sd(self.len)) or (
            p_alt == LOG_ZERO and not within_sd(0.0)
        ):
            return AlleleSupport(prob_ref=0.0, prob_alt=0.0, strand=STRAND_NONE)
        return AlleleSupport(prob_ref=p_ref, prob_alt=p_alt, strand=STRAND_NONE)

    # ---- sampling bias -------------------------------------------------
    def enclosable_len(self):
        return self.len

    def feasible_bases(self, read_len, props):
        # deletion.rs:95-111
        if props.max_del_cigar_len is not None and self.len <= props.max_del_cigar_len:
            return read_len
        if props.frac_max_softclip is not None:
            return int(read_len * props.frac_max_softclip)
        return None

    def prob_sample_alt(self, ev: Evidence, props):
        if ev.is_paired_evidence and props.insert_size is not None:
            return self.prob_sample_alt_fragment(
                ev.left.read_len, ev.right.read_len, props
            )
        return super().prob_sample_alt(ev, props)

    def prob_sample_alt_fragment(self, left_len, right_len, props):
        """fragments.rs:47-146.

        Memoized on the alignment-properties object: the result depends only
        on (variant len, read lens, feasible bases, isize model), and real
        libraries have a handful of distinct read lengths, so the +-6 SD
        erf grid is evaluated once per distinct key instead of per fragment.
        """
        lf = self.feasible_bases(left_len, props)
        rf = self.feasible_bases(right_len, props)
        if lf is None or rf is None:
            return LOG_ZERO
        cache = getattr(props, "_psa_frag_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(props, "_psa_frag_cache", cache)
        key = (self.len, left_len, right_len, lf, rf)
        hit = cache.get(key)
        if hit is not None:
            return hit
        out = self._psa_fragment_grid(left_len, right_len, lf, rf, props)
        cache[key] = out
        return out

    def _psa_fragment_grid(self, left_len, right_len, lf, rf, props):
        delta_ref = self.len
        delta_alt = 0
        infeasible_left = max(0, left_len - lf)
        infeasible_right = max(0, right_len - rf)
        infeasible = infeasible_left + infeasible_right
        mean, sd = props.insert_size.mean, props.insert_size.sd
        lo = max(0, int(round(mean)) - int(math.ceil(sd)) * 6)
        hi = int(round(mean)) + int(math.ceil(sd)) * 6
        probs = []
        for x in range(lo, hi):
            internal = max(0, x - left_len - right_len)
            infeasible_internal_alt = max(0, (internal + 1) - delta_alt)
            infeasible_alt = infeasible + infeasible_internal_alt
            infeasible_ref = max(0, (internal + 1) - delta_ref)
            valid_alt = max(0, x - delta_alt - infeasible_alt)
            valid_ref = max(0, x - infeasible_ref)
            if x <= delta_alt or x <= delta_alt + infeasible_alt or x <= infeasible_ref:
                continue
            if valid_ref == 0 or valid_alt == 0:
                continue
            probs.append(
                isize_pmf(x, mean, sd) + math.log(valid_alt) - math.log(valid_ref)
            )
        if not probs:
            return LOG_ZERO
        p = np_ln_sum_exp(np.array(probs))
        if 0.0 < p <= NUMERICAL_EPSILON:
            p = 0.0
        return min(p, 0.0)


class Insertion(RealignedVariant):
    def __init__(self, contig, pos, ins_seq: bytes, realigner):
        super().__init__(contig, realigner)
        self.pos = pos
        self.first_pos = pos
        self.ins_seq = bytes(b & ~0x20 for b in ins_seq)
        ref_seq = realigner.reference.seq(contig)
        self.homopolymer = None
        if is_homopolymer_seq(self.ins_seq):
            hend = (
                pos
                + len(self.ins_seq)
                + extend_homopolymer_stretch(self.ins_seq[0], ref_seq[pos + 1 :])
            )
            hstart = (
                pos
                + 1
                - extend_homopolymer_stretch(self.ins_seq[0], ref_seq[: pos + 1][::-1])
            )
            self.homopolymer = (hstart, hend)

    def realign_loci(self):
        return [(self.pos, self.pos + 1)]

    def fetch_intervals(self):
        return [(self.pos, self.pos + 1)]

    def homopolymer_error_model(self, props):
        if self.homopolymer is None:
            return None
        return HomopolymerErrorModel(len(self.ins_seq), props)

    def is_valid_evidence(self, ev: Evidence, props):
        for rec in ev.records():
            if locus_overlap(rec, self.pos, self.pos + 1, True) != 0:
                return [0]
        return None

    def enclosable_len(self):
        return len(self.ins_seq)

    def feasible_bases(self, read_len, props):
        if (
            props.max_ins_cigar_len is not None
            and len(self.ins_seq) <= props.max_ins_cigar_len
        ):
            return read_len
        if props.frac_max_softclip is not None:
            return int(read_len * props.frac_max_softclip)
        return None

    def alt_emission_params(self, ref_seq, region_start, region_end, ref_window):
        # insertion.rs:73-98, 250-261
        start = self.pos
        l = len(self.ins_seq)
        ref_offset = max(0, start - ref_window)
        ref_end = min(start + l + ref_window, len(ref_seq))
        # len_x = ref_end - ref_offset + ins_len (insertion.rs:271-274):
        # the ref suffix keeps ref_window + l bases after the anchor so a
        # read crossing the whole insertion still has allele to align to.
        seq = (
            bytes(ref_seq[ref_offset : start + 1])
            + self.ins_seq
            + bytes(ref_seq[start + 1 : ref_end])
        )
        return [
            AlleleEmission(
                seq=seq,
                ref_offset=ref_offset,
                # insertion.rs:267-269: range covers the inserted segment
                variant_ref_range=(start, start + l),
                homopolymer_ref_range=self.homopolymer,
                alt_vs_ref_len_diff=l,
            )
        ]


class _BreakendBacked(RealignedVariant):
    """INV/DUP delegate to a 4-breakend group exactly like the reference
    (inversion.rs:22-95, duplication.rs:20-95): the group's per-breakend
    assembled alt alleles cover both junction orientations and windows."""

    def __init__(self, contig, start, length, realigner):
        super().__init__(contig, realigner)
        self.start = start
        self.first_pos = start
        self.len = int(length)
        self.end = start + self.len
        from .breakends import Breakend, BreakendGroup

        self.group = BreakendGroup(
            contig, self._make_breakends(Breakend, realigner), realigner
        )

    def realign_loci(self):
        return self.group.realign_loci()

    def fetch_intervals(self):
        return self.group.fetch_intervals()

    def is_valid_evidence(self, ev: Evidence, props):
        return self.group.is_valid_evidence(ev, props)

    def alt_emission_params(self, ref_seq, region_start, region_end, ref_window):
        return self.group.alt_emission_params(
            ref_seq, region_start, region_end, ref_window
        )

    def enclosable_len(self):
        return self.len

    def _ref_base(self, pos):
        if pos < 0:
            # an INV/DUP starting at contig position 0 needs a breakend
            # BEFORE the contig (the reference underflows u64 here);
            # Python's negative indexing would silently return the LAST
            # contig base — fail loudly instead
            raise ValueError(
                f"breakend position {pos} before start of {self.contig}"
            )
        return chr(self.realigner.reference.seq(self.contig)[pos])


class Inversion(_BreakendBacked):
    def _make_breakends(self, Breakend, realigner):
        from .breakends import Join, SIDE_LEFT, SIDE_RIGHT

        s, e = self.start, self.end

        def bnd(pos, l2r, jpos, side, bid, mid):
            return Breakend(
                contig=self.contig,
                pos=pos,
                ref_allele=self._ref_base(pos),
                replacement=self._ref_base(pos),
                join=Join(contig=self.contig, pos=jpos, side=side, revcomp=True),
                is_left_to_right=l2r,
                id=bid,
                mateid=mid,
            )

        return [
            bnd(s - 1, True, e - 1, SIDE_LEFT, "w", "u"),
            bnd(s, False, e, SIDE_RIGHT, "v", "x"),
            bnd(e - 1, True, s - 1, SIDE_LEFT, "u", "w"),
            bnd(e, False, s, SIDE_RIGHT, "x", "v"),
        ]


class Duplication(_BreakendBacked):
    def _make_breakends(self, Breakend, realigner):
        from .breakends import Join, SIDE_LEFT, SIDE_RIGHT

        s, e = self.start, self.end

        def bnd(pos, l2r, jpos, side, bid, mid):
            return Breakend(
                contig=self.contig,
                pos=pos,
                ref_allele=self._ref_base(pos),
                replacement=self._ref_base(pos),
                join=Join(contig=self.contig, pos=jpos, side=side, revcomp=False),
                is_left_to_right=l2r,
                id=bid,
                mateid=mid,
            )

        return [
            bnd(s, False, e - 1, SIDE_LEFT, "u", "w"),
            bnd(s - 1, True, s, SIDE_RIGHT, "v", "."),
            bnd(e - 1, True, s, SIDE_RIGHT, "w", "u"),
            bnd(e, False, e - 1, SIDE_LEFT, "x", "."),
        ]


def single_indel_homopolymer_len(ref_allele: bytes, alt_allele: bytes):
    """HomopolymerIndelOperation::from_text_and_pattern_global
    (homopolymers.rs:20-50): detect a single homopolymer indel between two
    allele strings via longest common prefix/suffix (equivalent to the
    reference's global alignment restricted to the single-indel case)."""
    from ..evidence.edit_distance import M, I, homopolymer_indel_operation

    text, pattern = (ref_allele, alt_allele)
    flip = False
    if len(text) < len(pattern):
        text, pattern = pattern, text
        flip = True
    if len(text) == len(pattern):
        return None
    # longest common prefix/suffix
    p = 0
    while p < len(pattern) and text[p] == pattern[p]:
        p += 1
    s = 0
    while s < len(pattern) - p and text[len(text) - 1 - s] == pattern[len(pattern) - 1 - s]:
        s += 1
    if p + s < len(pattern):
        return None  # substitutions or multiple indels involved
    k = len(text) - len(pattern)
    from ..evidence.edit_distance import D

    ops = [M] * p + [D] * k + [M] * (len(pattern) - p)
    res = homopolymer_indel_operation(
        np.frombuffer(text, dtype=np.uint8),
        np.frombuffer(pattern, dtype=np.uint8),
        ops,
    )
    if res is None:
        return None
    length, _ = res
    return -length if flip else length


class Replacement(RealignedVariant):
    def __init__(self, contig, pos, ref_allele: bytes, alt_allele: bytes, realigner):
        super().__init__(contig, realigner)
        self.pos = pos
        self.first_pos = pos
        self.ref_allele = bytes(b & ~0x20 for b in ref_allele)
        self.alt_allele = bytes(b & ~0x20 for b in alt_allele)
        self.end = pos + len(self.ref_allele)
        # replacement.rs:43-45: single homopolymer indel detection between
        # the two alleles (sign: + = insertion in alt, - = deletion)
        self.homopolymer_indel_len_value = single_indel_homopolymer_len(
            self.ref_allele, self.alt_allele
        )

    def homopolymer_error_model(self, props):
        if self.homopolymer_indel_len_value is None:
            return None
        # sign already follows the variant convention (- = deletion)
        return HomopolymerErrorModel(self.homopolymer_indel_len_value, props)

    def realign_loci(self):
        return [(self.pos, self.end)]

    def fetch_intervals(self):
        return [(self.pos, self.end)]

    def is_valid_evidence(self, ev: Evidence, props):
        for rec in ev.records():
            if locus_overlap(rec, self.pos, self.end, True) != 0:
                return [0]
        return None

    def enclosable_len(self):
        return max(len(self.ref_allele), len(self.alt_allele))

    def alt_emission_params(self, ref_seq, region_start, region_end, ref_window):
        ref_offset = max(0, self.pos - ref_window)
        ref_end = min(self.end + ref_window, len(ref_seq))
        seq = (
            bytes(ref_seq[ref_offset : self.pos])
            + self.alt_allele
            + bytes(ref_seq[self.end : ref_end])
        )
        return [
            AlleleEmission(
                seq=seq,
                ref_offset=ref_offset,
                # replacement.rs:290-292: repl_start..repl_alt_end
                variant_ref_range=(self.pos, self.pos + len(self.alt_allele)),
                homopolymer_ref_range=(
                    (self.pos, self.pos + len(self.ref_allele))
                    if self.homopolymer_indel_len_value is not None
                    else None
                ),
                alt_vs_ref_len_diff=len(self.alt_allele) - len(self.ref_allele),
            )
        ]


class HomopolymerErrorModel:
    """utils/homopolymers.rs HomopolymerErrorModel: observation probabilities
    for homopolymer indels of given lengths from the wildtype error
    histogram."""

    def __init__(self, variant_indel_len: int, props):
        self.variant_homopolymer_indel_len = variant_indel_len
        model = props.wildtype_homopolymer_error_model
        # homopolymers.rs:180-216: normalize over valid nonzero indel lens
        valid = {k: v for k, v in model.items() if k != 0 and -128 <= k <= 127}
        total = sum(valid.values()) or 1.0
        self._probs = {k: v / total for k, v in valid.items()}

    def prob_observable(self, indel_len: int) -> float:
        p = self._probs.get(int(indel_len), 0.0)
        return math.log(p) if p > 0 else LOG_ZERO
