"""Breakend (BND) groups: spec parsing, alt-allele assembly, evidence.

Port of ``src/variants/types/breakends.rs`` (1212 LoC):
- BND ALT spec grammar (``t[p[``/``]p]t`` joins, single breakends ``.t``/``t.``,
  assembly-file insertions skipped) — ``breakends.rs:932-1067``,
- groups joined by EVENT / MATEID pairs,
- alt allele assembly by following breakend joins with revcomp handling
  (``breakends.rs:629-838``),
- precise groups -> realignment against the assembled alt alleles,
- imprecise pairs -> paired-end positional classification
  (``breakends.rs:254-299``) and isize-marginalized deletion support over the
  CI grid with a uniform prior (``breakends.rs:406-446``),
- the min-10-ref-bases rule (``breakends.rs:41,325-340``).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np

from ..utils.logprob import LOG_ZERO, np_ln_sum_exp
from .extraction import Evidence, locus_overlap
from .indels import RealignedVariant, isize_pmf, estimate_insert_size, revcomp
from .observation import STRAND_NONE
from .realignment import AlleleEmission
from .variants import AlleleSupport

MIN_REF_BASES = 10

_RE_OP = re.compile(
    r"(?P<replacement>[ACGTNacgtn]+)"
    r"|(?P<bracket1>[\]\[])(?P<anglebracket1><)?(?P<contig>[^\]\[:>]+)"
    r"(?P<anglebracket2>>)?(:(?P<pos>[0-9]+))?(?P<bracket2>[\]\[])"
)
_RE_SINGLE = re.compile(
    r"(\.(?P<from_right>[ACGTNacgtn]+))|((?P<from_left>[ACGTNacgtn]+)\.)"
)

SIDE_LEFT = "left_of_pos"
SIDE_RIGHT = "right_of_pos"


@dataclass
class Join:
    contig: str
    pos: int
    side: str
    revcomp: bool


@dataclass
class Breakend:
    contig: str
    pos: int
    ref_allele: str
    replacement: str
    join: Join | None
    is_left_to_right: bool
    id: str
    mateid: str | None
    precise: bool = True
    ci_start: tuple = (0, 0)  # signed (lo, hi) around pos

    @classmethod
    def parse(cls, contig, pos, ref_allele, spec, rec_id, mateid, precise=True, ci=(0, 0)):
        """breakends.rs:932-1067. Returns None for assembly-file insertions."""
        singles = list(_RE_SINGLE.finditer(spec))
        ops = list(_RE_OP.finditer(spec))
        if len(singles) == 1:
            caps = singles[0]
            if caps.group("from_left"):
                l2r, repl = True, caps.group("from_left")
            else:
                l2r, repl = False, caps.group("from_right")
            return cls(
                contig=contig,
                pos=pos,
                ref_allele=ref_allele,
                replacement=repl.upper(),
                join=None,
                is_left_to_right=l2r,
                id=rec_id,
                mateid=None,
                precise=precise,
                ci_start=ci,
            )
        if len(ops) != 2:
            raise ValueError(f"invalid BND spec {spec!r}")
        replacement = None
        join = None
        is_left_to_right = False
        for caps in ops:
            if caps.group("replacement"):
                if join is None:
                    is_left_to_right = True
                replacement = caps.group("replacement").upper()
            else:
                b1, b2 = caps.group("bracket1"), caps.group("bracket2")
                if b1 != b2:
                    raise ValueError(f"invalid BND spec {spec!r}")
                if caps.group("anglebracket1") and caps.group("anglebracket2"):
                    return None  # assembly file insertion: skip
                if bool(caps.group("anglebracket1")) != bool(caps.group("anglebracket2")):
                    raise ValueError(f"invalid BND spec {spec!r}")
                jcontig = caps.group("contig")
                jpos = int(caps.group("pos")) - 1
                side = SIDE_RIGHT if b1 == "[" else SIDE_LEFT
                if is_left_to_right:
                    rc = b1 == "]"
                else:
                    rc = b1 == "["
                join = Join(contig=jcontig, pos=jpos, side=side, revcomp=rc)
        return cls(
            contig=contig,
            pos=pos,
            ref_allele=ref_allele,
            replacement=replacement,
            join=join,
            is_left_to_right=is_left_to_right,
            id=rec_id,
            mateid=mateid,
            precise=precise,
            ci_start=ci,
        )

    @property
    def emits_revcomp(self):
        return self.join is not None and self.join.revcomp

    def min_pos(self):
        """pos - CIPOS[0] (reference subtracts the first CI component,
        breakends.rs:1170-1177)."""
        if self.precise:
            return self.pos
        return max(0, self.pos - abs(self.ci_start[0]))

    def max_pos(self):
        if self.precise:
            return self.pos
        return self.pos + max(self.ci_start[1], 0)


class BreakendGroup(RealignedVariant):
    uses_read_pair_window = True

    def __init__(self, contig, breakends: list[Breakend], realigner):
        super().__init__(contig, realigner)
        self.breakends = sorted(breakends, key=lambda b: (b.contig, b.pos))
        self.first_pos = self.breakends[0].pos
        self.contig = self.breakends[0].contig
        self.imprecise = not all(b.precise for b in self.breakends)
        self._alt_cache = None

        # enclosable ref interval (breakends.rs:105-131)
        self.enclosable = None
        if all(b.contig == self.breakends[0].contig for b in self.breakends):
            last = self.breakends[-1]
            end = last.pos + (len(last.ref_allele) if not last.is_left_to_right else 0)
            self.enclosable = (self.breakends[0].pos, end)

    @classmethod
    def build(cls, contig, breakends, realigner):
        """Returns None for unsupported imprecise configurations
        (breakends.rs:132-163)."""
        if not breakends:
            return None
        imprecise = not all(b.precise for b in breakends)
        if imprecise:
            if len(breakends) != 2:
                return None
            if any(b.emits_revcomp or b.replacement != b.ref_allele for b in breakends):
                return None
        return cls(contig, breakends, realigner)

    # -- geometry -------------------------------------------------------
    def loci(self):
        return [
            (b.contig, b.pos, b.pos + len(b.ref_allele)) for b in self.breakends
        ]

    def realign_loci(self):
        return [
            (b.pos, b.pos + len(b.ref_allele))
            for b in self.breakends
            if b.contig == self.contig
        ]

    def fetch_intervals(self):
        return self.realign_loci()

    def breakend_pair(self):
        if len(self.breakends) == 2:
            return self.breakends[0], self.breakends[1]
        return None

    def is_insertion(self):
        pair = self.breakend_pair()
        if pair:
            l, r = pair
            if (
                l.pos + 1 == r.pos
                and l.contig == r.contig
                and not l.emits_revcomp
                and not r.emits_revcomp
                and l.is_left_to_right
                and len(l.replacement) > 1
                and r.replacement[: len(r.replacement) - 1] == l.replacement[1:]
                and not r.is_left_to_right
            ):
                return True
        return False

    def is_deletion(self):
        pair = self.breakend_pair()
        if pair:
            l, r = pair
            return (
                l.contig == r.contig
                and len(l.replacement) == 1
                and len(r.replacement) == 1
                and l.is_left_to_right
                and not r.is_left_to_right
                and not l.emits_revcomp
                and not r.emits_revcomp
            )
        return False

    @property
    def is_imprecise(self):
        return self.imprecise

    # -- evidence gating ------------------------------------------------
    def _classify_imprecise(self, ev: Evidence):
        """breakends.rs:254-299. Returns 'support' | 'nosupport' | None."""
        if not ev.is_paired_evidence:
            return None

        def is_match(bnd, rec):
            if bnd.contig != self.contig:
                return False
            if bnd.is_left_to_right:
                return rec.end_pos < bnd.max_pos()
            return rec.pos > bnd.min_pos()

        l, r = self.breakends[0], self.breakends[1]
        for bnd, other in ((l, r), (r, l)):
            if bnd.is_left_to_right:
                if is_match(bnd, ev.left):
                    return "support" if is_match(other, ev.right) else "nosupport"
            elif is_match(bnd, ev.right):
                return "support" if is_match(other, ev.left) else "nosupport"
        return None

    def is_valid_evidence(self, ev: Evidence, props):
        if self.imprecise:
            return [0, 1] if self._classify_imprecise(ev) is not None else None

        def valid_ref_bases(rec):
            if self.enclosable is None:
                return True
            s, e = self.enclosable
            return max(max(0, s - rec.pos), max(0, rec.end_pos - e)) > MIN_REF_BASES

        loci = self.realign_loci()
        idx = []
        for i, (s, e) in enumerate(loci):
            for rec in ev.records():
                if locus_overlap(rec, s, e, True) != 0:
                    idx.append(i)
                    break
        if not idx:
            return None
        if not any(valid_ref_bases(r) for r in ev.records()):
            return None
        return idx

    # -- allele support -------------------------------------------------
    def allele_support(self, ev: Evidence, props, alt_variants=()):
        if self.imprecise:
            cls = self._classify_imprecise(ev)
            if cls is None:
                return None
            if self.is_deletion() and props.insert_size is not None:
                l_bnd, r_bnd = self.breakends
                probs_alt = []
                prob_ref = None
                for lp in range(l_bnd.min_pos(), l_bnd.max_pos() + 1):
                    for rp in range(r_bnd.min_pos(), r_bnd.max_pos() + 1):
                        if lp < rp:
                            s = self._isize_support(ev.left, ev.right, rp - lp, props)
                            if prob_ref is None:
                                prob_ref = s.prob_ref_allele()
                            probs_alt.append(s.prob_alt_allele())
                if probs_alt:
                    prior = -math.log(len(probs_alt))
                    prob_alt = np_ln_sum_exp(np.array(probs_alt) + prior)
                    if prob_ref != prob_alt:
                        return AlleleSupport(
                            prob_ref=prob_ref, prob_alt=prob_alt, strand=STRAND_NONE
                        )
            if cls == "support":
                return AlleleSupport(prob_ref=LOG_ZERO, prob_alt=0.0, strand=STRAND_NONE)
            return AlleleSupport(prob_ref=0.0, prob_alt=LOG_ZERO, strand=STRAND_NONE)
        return super().allele_support(ev, props, alt_variants)

    def _isize_support(self, left, right, del_len, props):
        insert_size = estimate_insert_size(left, right)
        p_ref = isize_pmf(insert_size, props.insert_size.mean, props.insert_size.sd)
        p_alt = isize_pmf(
            insert_size, props.insert_size.mean + del_len, props.insert_size.sd
        )

        def within_sd(shift):
            return abs(insert_size - (props.insert_size.mean + shift)) <= props.insert_size.sd

        if (p_ref == LOG_ZERO and not within_sd(del_len)) or (
            p_alt == LOG_ZERO and not within_sd(0.0)
        ):
            return AlleleSupport(prob_ref=0.0, prob_alt=0.0, strand=STRAND_NONE)
        return AlleleSupport(prob_ref=p_ref, prob_alt=p_alt, strand=STRAND_NONE)

    # -- sampling bias --------------------------------------------------
    def enclosable_len(self):
        if self.is_deletion():
            l, r = self.breakends
            left_add = l.ci_start[1] if not l.precise else 0
            right_sub = r.ci_start[0] if not r.precise else 0
            return (r.pos - right_sub) - (l.pos + left_add)
        if self.is_insertion():
            return len(self.breakends[0].replacement) - 1
        return None

    def feasible_bases(self, read_len, props):
        if self.imprecise:
            return 0
        el = self.enclosable_len()
        if self.is_deletion() and el is not None and props.max_del_cigar_len is not None:
            if el <= props.max_del_cigar_len:
                return read_len
        if self.is_insertion() and el is not None and props.max_ins_cigar_len is not None:
            if el <= props.max_ins_cigar_len:
                return read_len
        if props.frac_max_softclip is not None:
            return int(read_len * props.frac_max_softclip)
        return None

    def prob_sample_alt(self, ev: Evidence, props):
        if self.imprecise:
            return 0.0
        return super().prob_sample_alt(ev, props)

    # -- alt allele assembly (breakends.rs:629-838) ---------------------
    def _upstream_bnd(self, contig, pos):
        for b in reversed(self.breakends):
            if b.contig == contig and b.pos < pos and not b.is_left_to_right:
                return b
        return None

    def _downstream_bnd(self, contig, pos):
        for b in self.breakends:
            if b.contig == contig and b.pos > pos and b.is_left_to_right:
                return b
        return None

    def alt_emission_params(self, ref_seq_unused, region_start, region_end, ref_window):
        if self._alt_cache is not None and self._alt_cache[0] == ref_window:
            return self._alt_cache[1]
        out = []
        reference = self.realigner.reference
        for first in self.breakends:
            seq = self._assemble_alt(first, reference, ref_window)
            if seq:
                out.append(AlleleEmission(seq=seq, ref_offset=0))
        self._alt_cache = (ref_window, out)
        return out

    def _assemble_alt(self, first: Breakend, reference, ref_window) -> bytes:
        def ref_seq(contig):
            return reference.seq(contig)

        parts_front = []  # prepended (reversed order)
        parts_back = []
        total_len = 0

        def push(seq: bytes, front: bool):
            nonlocal total_len
            total_len += len(seq)
            if front:
                parts_front.append(seq)
            else:
                parts_back.append(seq)

        rs = ref_seq(first.contig)
        if first.is_left_to_right:
            pstart = max(0, first.pos - ref_window)
            push(bytes(rs[pstart : first.pos]), False)
            push(first.replacement.encode(), False)
        else:
            sstart = first.pos + 1
            push(bytes(rs[sstart : min(sstart + ref_window, len(rs))]), True)
            push(first.replacement.encode(), True)

        rc = False
        next_bnd = first
        visited = set()
        while next_bnd is not None:
            current = next_bnd
            if current.id in visited:
                crs = ref_seq(current.contig)
                if current.is_left_to_right:
                    sstart = current.pos + 1
                    push(bytes(crs[sstart : min(sstart + ref_window, len(crs))]), False)
                else:
                    pstart = max(0, current.pos - ref_window)
                    push(bytes(crs[pstart : current.pos]), True)
                break
            visited.add(current.id)
            l2r = (not current.is_left_to_right) if rc else current.is_left_to_right
            if current.join is None:
                break
            join = current.join
            jrs = ref_seq(join.contig)
            if join.side == SIDE_LEFT:
                next_bnd = self._upstream_bnd(join.contig, join.pos)
                seq_start = next_bnd.pos + 1 if next_bnd is not None else 0
                seq = bytes(jrs[seq_start : join.pos + 1])
            else:
                next_bnd = self._downstream_bnd(join.contig, join.pos)
                seq_end = next_bnd.pos if next_bnd is not None else len(jrs)
                seq = bytes(jrs[join.pos : seq_end])
            if next_bnd is not None:
                if join.side == SIDE_RIGHT:
                    seq = seq + next_bnd.replacement.encode()
                else:
                    seq = next_bnd.replacement.encode() + seq
            ext_rc = (not join.revcomp) if rc else join.revcomp
            if next_bnd is not None and total_len + len(seq) > ref_window:
                next_bnd = None
            if ext_rc:
                seq = revcomp(np.frombuffer(seq, dtype=np.uint8))
            if next_bnd is not None:
                push(seq, not l2r)
            elif l2r:
                push(seq[: min(ref_window, len(seq))], False)
            else:
                push(seq[max(0, len(seq) - ref_window) :], True)
            rc = ext_rc
        return b"".join(reversed(parts_front)) + b"".join(parts_back)
