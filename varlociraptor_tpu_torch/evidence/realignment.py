"""Realignment: per-read ref/alt allele likelihoods via the pair-HMM kernel.

Re-implements the reference's ``Realigner`` machinery
(``src/variants/evidence/realignment/mod.rs:57-490``):
candidate read/ref window selection around breakpoints, window merging,
allele emission construction per variant type, forward probabilities through
``ops.pairhmm``, ref/alt normalization, and strand extraction.  The Myers
edit-distance pre-filter/banding is replaced by the batched full-window
forward (see ops/pairhmm.py docstring); the edit-distance engine for
third-allele rescue and homopolymer-length extraction lives in
``evidence.edit_distance`` and is layered on top.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..io.bam import BamRecord, OP_D, OP_EQ, OP_H, OP_I, OP_M, OP_N, OP_S, OP_X
from ..ops.pairhmm import BatchedPairHMM
from ..utils.logprob import LOG_ZERO, np_ln_add_exp
from .observation import STRAND_NONE
from .variants import AlleleSupport, strand_from_record
from ..evidence.edit_distance import (  # noqa: E402
    EDIT_BAND,
    EditHit,
    calc_hit,
    derive_patched_allele,
    finish_hit,
)

MAX_PATTERN_LEN = 128  # edit_distance.rs:138

# Experimental reference-parity switches (see allele_support):
#   VLT_PRESELECT=1   -> prob_allele min-edit-dist preselection + strict
#                        third-allele rescue (realignment/mod.rs:426-479,317)
import os as _os

_PARITY_PRESELECT = _os.environ.get("VLT_PRESELECT", "0") == "1"

_MEMO_MISS = object()


# placeholder hit returned during the scout pass (explainable=None, so no
# patched-allele forwards are queued from scout)
_SCOUT_HIT = EditHit(dist=0, start=0, end=0, ops=[])


def read_pos_full(record: BamRecord, ref_pos: int, include_softclips=True, include_dels=True):
    """htslib cigar read_pos(pos, true, true): query index for a reference
    position, counting softclips as aligned and returning the preceding query
    index within deletions."""
    q = 0
    r = record.pos
    first = True
    for op, l in record.cigar:
        l = int(l)
        if op == OP_H:
            # hard clips consume neither query nor reference and must not
            # demote a following leading softclip (supplementary split
            # reads routinely start H+S; rust-htslib read_pos skips them)
            continue
        if op == OP_S:
            if include_softclips:
                # softclip treated as if aligned before/after the read
                if first:
                    start = r - l
                    if start <= ref_pos < r:
                        return q + (ref_pos - start)
                else:
                    if r <= ref_pos < r + l:
                        return q + (ref_pos - r)
            q += l
        elif op in (OP_M, OP_EQ, OP_X):
            if r <= ref_pos < r + l:
                return q + (ref_pos - r)
            q += l
            r += l
        elif op == OP_I:
            q += l
        elif op in (OP_D, OP_N):
            if r <= ref_pos < r + l:
                return q if include_dels else None
            r += l
        first = False
    return None


@dataclass
class CandidateRegion:
    overlap: bool
    read_start: int
    read_end: int
    ref_start: int
    ref_end: int


@dataclass
class AlleleEmission:
    """One allele window: a concrete byte sequence plus the variant ref-range
    (for edit-op counting) and homopolymer metadata."""

    seq: bytes
    ref_offset: int
    variant_ref_range: tuple | None = None
    homopolymer_ref_range: tuple | None = None
    alt_vs_ref_len_diff: int = 0


def path_score(ops, read_window, quals, gap):
    """Fast mode: score only the best edit path under the HMM model
    (PathHMMRealigner, realignment/mod.rs:546-677)."""
    from ..evidence.edit_distance import D, I, M, S

    t_mi, t_md, t_ii, t_dd = (float(g) for g in gap)
    t_mm = math.log(max(1.0 - math.exp(t_mi) - math.exp(t_md), 1e-12))
    close_i = math.log(max(1.0 - math.exp(t_ii), 1e-12))
    close_d = math.log(max(1.0 - math.exp(t_dd), 1e-12))
    # extend OR close-then-reopen (mod.rs:570-575)
    ext_or_reopen_i = np.logaddexp(t_ii, close_i + t_mi)
    ext_or_reopen_d = np.logaddexp(t_dd, close_d + t_md)
    total = 0.0
    prev = None
    j = 0
    for op in ops:
        if op in (M, S):
            if prev == "I":
                total += close_i
            elif prev == "D":
                total += close_d
            elif prev == "M":
                total += t_mm
            mis = -float(quals[j]) * math.log(10.0) / 10.0
            if op == M:
                total += math.log1p(-math.exp(mis))
            else:
                total += mis + math.log(0.3333)
            j += 1
            prev = "M"
        elif op == I:
            if prev == "I":
                total += ext_or_reopen_i
            elif prev == "D":
                total += close_d + t_mi
            else:
                total += t_mi
            total += -float(quals[j]) * math.log(10.0) / 10.0
            j += 1
            prev = "I"
        elif op == D:
            if prev == "D":
                total += ext_or_reopen_d
            elif prev == "I":
                total += close_i + t_md
            else:
                total += t_md
            prev = "D"
    return total


class Realigner:
    def __init__(
        self,
        reference,
        props,
        indel_window: int = 64,
        max_window: int = 64,
        mode: str = "exact",
    ):
        self.reference = reference
        self.props = props
        self.max_window = max_window
        self.mode = mode
        self.hmm = BatchedPairHMM(
            props.gap_params, hop_params=props.hop_params, mode=mode
        )
        # record/replay batching: extraction runs the pileup twice — once
        # recording every forward request (device untouched), then one
        # batched forward for the whole pileup, then a replay pass that
        # consumes the results in the identical call order. Requires all
        # forward calls to be host-deterministic (they are: the patched-
        # allele forward is gated only on edit-distance state).
        self._batch_mode = None  # None | "scout" | "record" | "replay"
        self._requests = None
        self._results = None
        self._cursor = 0
        self._scout = None
        # host-side memos alive for one record/replay cycle: the two passes
        # (and reads sharing identical windows) recompute identical edit
        # hits and allele emissions; EditHit/AlleleEmission objects are
        # immutable after construction so sharing is safe
        self._hit_memo = None
        self._em_memo = None

    # -- batched dispatch ----------------------------------------------
    def _forward(self, seqs, reads, quals, max_dists=None):
        if max_dists is None:
            max_dists = [None] * len(seqs)
        if self._batch_mode == "record":
            self._requests.append((seqs, reads, quals, max_dists))
            return np.zeros(len(seqs), dtype=np.float64)
        if self._batch_mode == "replay":
            out = self._results[self._cursor : self._cursor + len(seqs)]
            self._cursor += len(seqs)
            return out
        return self.hmm.forward(seqs, reads, quals, max_dists)

    def begin_scout(self):
        """Single host pass: allele_support runs with dummy edit hits,
        ENUMERATING the (allele, read-window) pairs of the whole pileup and
        queueing SYMBOLIC forward requests; flush_scout then computes every
        edit hit in one native batch, and run_batch/collect_requests
        materializes the shrunk windows, bands and patched-allele forwards
        from the memoized hits — no separate record pass."""
        self._batch_mode = "scout"
        self._requests = []
        self._hit_memo = {}
        self._em_memo = {}
        self._scout = {}

    def flush_scout(self):
        from ..io.native import hybrid_hits_batch

        scout = self._scout
        self._scout = None
        if scout:
            items = list(scout.items())
            parts = hybrid_hits_batch(
                [bytes(em.seq) for _, (em, _rb, _er, _pr) in items],
                [rb for _, (_em, rb, _er, _pr) in items],
            )
            if parts is not None:
                for (key, (em, rb, er, pr)), (dist, start, ops, last, second) in zip(
                    items, parts
                ):
                    self._hit_memo[key] = finish_hit(
                        em,
                        np.frombuffer(rb, dtype=np.uint8),
                        pr,
                        er,
                        dist,
                        start,
                        ops,
                        last,
                        second,
                    )
        self._batch_mode = "queued"

    def _shrunk_bands(self, emissions, hits):
        """Hit-anchored window shrink + band per allele
        (shrink_to_hit, pairhmm.rs:66-73; dist_upper_bound = dist +
        EDIT_BAND, edit_distance.rs:493-497)."""
        shrunk, bands = [], []
        for em, hit in zip(emissions, hits):
            if hit is None:
                shrunk.append(em.seq)
                bands.append(None)
            else:
                lo = max(hit.start - EDIT_BAND, 0)
                hi = min(hit.end + EDIT_BAND, len(em.seq))
                shrunk.append(em.seq[lo:hi])
                bands.append(hit.dist + EDIT_BAND)
        return shrunk, bands

    def _forward_alleles(self, emissions, hits, read_window, qual_window,
                         props, error_rate, n_ref):
        """Forward probs for one allele set. In the scout pass this queues
        the SYMBOLIC request (emissions + windows; the hit-derived shrink,
        bands and patched-allele follow-ups materialize in
        collect_requests once the hit batch has run)."""
        if self._batch_mode == "scout":
            self._requests.append(
                (emissions, n_ref, read_window, qual_window, props, error_rate)
            )
            return np.zeros(len(emissions), dtype=np.float64)
        shrunk, bands = self._shrunk_bands(emissions, hits)
        n = len(shrunk)
        return self._forward(
            shrunk, [read_window] * n, [qual_window] * n, bands
        )

    def _derive_patched(self, a_em, a_hit, read_window):
        """Memoized patched-allele derivation incl. the same-length-patch
        skip (see allele_support: a same-length patch of an indel variant
        is the same event, not a third allele)."""
        if a_hit is None:
            return None
        em_memo = self._em_memo
        if em_memo is not None:
            pkey = ("patch", id(a_em), id(a_hit), read_window.tobytes())
            patched = em_memo.get(pkey, _MEMO_MISS)
            if patched is _MEMO_MISS:
                patched = derive_patched_allele(a_em, read_window, a_hit)
                em_memo[pkey] = patched
        else:
            patched = derive_patched_allele(a_em, read_window, a_hit)
        if (
            not _PARITY_PRESELECT
            and patched is not None
            and a_em.alt_vs_ref_len_diff != 0
            and len(patched) == len(a_em.seq)
        ):
            patched = None
        return patched

    def _patched_window(self, a_em, a_hit, read_window, props, error_rate):
        """Third-allele-rescue patched allele + its hit (memoized so the
        materialization in collect_requests and the replay pass make the
        IDENTICAL queueing decision). Returns (patched, phit) or
        (None, None)."""
        patched = self._derive_patched(a_em, a_hit, read_window)
        if patched is None:
            return None, None
        phit = self._calc_hit(
            AlleleEmission(seq=patched, ref_offset=a_em.ref_offset),
            read_window,
            props,
            error_rate,
            is_patched=True,
        )
        return patched, phit

    def collect_requests(self):
        """Materialize the symbolic requests into flattened forward items:
        (seqs, reads, quals, dists).  Hits come from the memo primed by
        flush_scout; the patched-allele follow-up forwards are appended per
        request exactly as the replay pass will re-derive them.  Used by
        run_batch and by cross-locus chunked execution (the preprocess
        driver concatenates requests of MANY loci into one device call)."""
        # phase A: base-allele hits are batched inside _calc_hits; derive
        # every patched allele and collect the hit-memo MISSES so their
        # edit alignments run as ONE native batch too (they were the last
        # per-call ctypes crossings in the del workload, ~60 us each)
        memo = self._hit_memo
        req_hits = []
        patch_miss: dict = {}
        for emissions, n_ref, rw, qw, props, er in self._requests:
            hits = self._calc_hits(emissions, rw, props, er)
            req_hits.append(hits)
            if memo is None:
                continue
            rb = rw.tobytes()
            for a_em, a_hit in zip(emissions[n_ref:], hits[n_ref:]):
                patched = self._derive_patched(a_em, a_hit, rw)
                if patched is None or len(patched) == 0 or len(rw) == 0:
                    continue
                em_p = AlleleEmission(seq=patched, ref_offset=a_em.ref_offset)
                key = (
                    em_p.seq,
                    em_p.ref_offset,
                    em_p.variant_ref_range,
                    em_p.homopolymer_ref_range,
                    rb,
                    er,
                    True,
                )
                if key not in memo and key not in patch_miss:
                    patch_miss[key] = (em_p, rw, props, er)
        if patch_miss:
            from ..io.native import hybrid_hits_batch

            items = list(patch_miss.items())
            parts = hybrid_hits_batch(
                [bytes(em.seq) for _, (em, rw, _p, _e) in items],
                [rw.tobytes() for _, (_em, rw, _p, _e) in items],
            )
            if parts is not None:
                for (key, (em, rw, props, er)), (
                    dist, start, ops, last_start, second
                ) in zip(items, parts):
                    memo[key] = finish_hit(
                        em, rw, props, er,
                        dist, start, ops, last_start, second, True,
                    )

        # phase B: assemble the flattened forward items (hits + patched
        # hits now come from the memo)
        seqs, reads, quals, dists = [], [], [], []
        for (emissions, n_ref, rw, qw, props, er), hits in zip(
            self._requests, req_hits
        ):
            shrunk, bands = self._shrunk_bands(emissions, hits)
            n = len(shrunk)
            seqs.extend(shrunk)
            reads.extend([rw] * n)
            quals.extend([qw] * n)
            dists.extend(bands)
            for a_em, a_hit in zip(emissions[n_ref:], hits[n_ref:]):
                patched, phit = self._patched_window(a_em, a_hit, rw, props, er)
                if patched is not None:
                    lo = max(phit.start - EDIT_BAND, 0)
                    hi = min(phit.end + EDIT_BAND, len(patched))
                    seqs.append(patched[lo:hi])
                    reads.append(rw)
                    quals.append(qw)
                    dists.append(phit.dist + EDIT_BAND)
        return seqs, reads, quals, dists

    def set_results(self, results):
        """Install externally computed forward results and switch to
        replay mode."""
        self._results = np.asarray(results, dtype=np.float64)
        self._batch_mode = "replay"
        self._cursor = 0

    def run_batch(self):
        """Execute all recorded forwards in one padded device call."""
        seqs, reads, quals, dists = self.collect_requests()
        self.set_results(
            self.hmm.forward(seqs, reads, quals, dists)
            if seqs
            else np.zeros(0)
        )

    def end_batch(self):
        self._batch_mode = None
        self._requests = None
        self._results = None
        self._cursor = 0
        self._hit_memo = None
        self._em_memo = None
        self._scout = None

    def _calc_hit(self, em, read_window, props, error_rate, is_patched=False):
        """calc_hit with a per-batch-cycle memo (record and replay passes
        compute identical hits; nearby reads often share windows)."""
        if self._hit_memo is None:
            return calc_hit(em, read_window, props, error_rate, is_patched)
        key = (
            em.seq,
            em.ref_offset,
            em.variant_ref_range,
            em.homopolymer_ref_range,
            read_window.tobytes(),
            error_rate,
            is_patched,
        )
        hit = self._hit_memo.get(key, _MEMO_MISS)
        if hit is _MEMO_MISS:
            hit = calc_hit(em, read_window, props, error_rate, is_patched)
            self._hit_memo[key] = hit
        return hit

    def _calc_hits(self, emissions, read_window, props, error_rate):
        """Batched _calc_hit over one allele set: memo lookups first, then
        ONE native library call for all misses (hybrid_hits_batch) instead
        of a ctypes crossing per allele."""
        memo = self._hit_memo
        if memo is None:
            return [
                self._calc_hit(em, read_window, props, error_rate)
                for em in emissions
            ]
        rb = read_window.tobytes()
        out = [None] * len(emissions)
        keys = [None] * len(emissions)
        misses = []
        scouting = self._batch_mode == "scout"
        for i, em in enumerate(emissions):
            key = (
                em.seq,
                em.ref_offset,
                em.variant_ref_range,
                em.homopolymer_ref_range,
                rb,
                error_rate,
                False,
            )
            keys[i] = key
            got = memo.get(key, _MEMO_MISS)
            if got is _MEMO_MISS:
                if len(em.seq) == 0 or len(read_window) == 0:
                    memo[key] = None
                elif scouting:
                    # enumerate for the pileup-wide batch; dummy hit back
                    if key not in self._scout:
                        self._scout[key] = (em, rb, error_rate, props)
                    out[i] = _SCOUT_HIT
                else:
                    misses.append(i)
            else:
                out[i] = got
        if scouting:
            return out
        if misses:
            from ..io.native import hybrid_hits_batch

            parts = hybrid_hits_batch(
                [bytes(emissions[i].seq) for i in misses], [rb] * len(misses)
            )
            if parts is None:
                for i in misses:
                    hit = calc_hit(emissions[i], read_window, props, error_rate)
                    memo[keys[i]] = hit
                    out[i] = hit
            else:
                for i, (dist, start, ops, last_start, second) in zip(
                    misses, parts
                ):
                    hit = finish_hit(
                        emissions[i], read_window, props, error_rate,
                        dist, start, ops, last_start, second,
                    )
                    memo[keys[i]] = hit
                    out[i] = hit
        return out

    @property
    def ref_window(self):
        # realignment/mod.rs:155-159
        return int(self.max_window * 1.5)

    # ------------------------------------------------------------------
    def candidate_region(self, record: BamRecord, locus_start, locus_end, ref_len):
        """realignment/mod.rs:58-153."""
        qstart = read_pos_full(record, locus_start)
        qend = read_pos_full(record, locus_end)
        w = self.max_window

        def ref_interval(breakpoint):
            return (
                max(0, breakpoint - self.ref_window),
                min(breakpoint + self.ref_window, ref_len),
            )

        if qstart is not None and qend is not None:
            max_w = max(0, w - (qend - qstart) // 2)
            read_offset = max(0, qstart - max_w)
            read_end = min(qend + max_w, record.read_len)
            exceed = (read_end - read_offset) - MAX_PATTERN_LEN
            if exceed > 0:
                read_offset += exceed // 2
                read_end -= (exceed + 1) // 2
            rs, re = ref_interval(locus_start)
            return CandidateRegion(True, read_offset, read_end, rs, re)
        if qstart is not None:
            read_offset = max(0, qstart - w)
            read_end = min(qstart + w, record.read_len)
            rs, re = ref_interval(locus_start)
            return CandidateRegion(True, read_offset, read_end, rs, re)
        if qend is not None:
            read_offset = max(0, qend - w)
            read_end = min(qend + w, record.read_len)
            rs, re = ref_interval(locus_end)
            return CandidateRegion(True, read_offset, read_end, rs, re)
        m = record.read_len // 2
        read_offset = max(0, m - w)
        read_end = min(m + w - 1, record.read_len)
        breakpoint = record.pos + m
        read_enclosed = record.pos >= locus_start and record.end_pos <= locus_end
        rs, re = ref_interval(breakpoint)
        return CandidateRegion(read_enclosed, read_offset, read_end, rs, re)

    # ------------------------------------------------------------------
    def _region_preamble(self, record, loci, contig_len):
        """Region computation + window slicing + error rate for one
        (record, loci) pair — identical across the scout/record/replay
        passes, so memoized for the batch cycle.  Returns None when no
        region overlaps (the log-0.5 early exit), else
        [(region, read_window, qual_window, error_rate)]."""
        memo = self._em_memo
        key = (id(record), tuple(loci)) if memo is not None else None
        if key is not None:
            hit = memo.get(key, _MEMO_MISS)
            if hit is not _MEMO_MISS:
                return hit
        regions = [
            self.candidate_region(record, start, end, contig_len)
            for start, end in loci
        ]
        out = None
        if any(r.overlap for r in regions):
            # merge overlapping ref regions (mod.rs:200-222)
            merged = []
            for r in regions:
                if not r.overlap:
                    continue
                if merged and r.ref_start <= merged[-1].ref_end:
                    last = merged[-1]
                    last.ref_end = r.ref_end
                    last.read_start = min(last.read_start, r.read_start)
                    last.read_end = max(last.read_end, r.read_end)
                else:
                    merged.append(r)
            out = []
            for region in merged:
                read_window = record.seq[region.read_start : region.read_end]
                qual_window = record.qual[region.read_start : region.read_end]
                # ReadEmission::error_rate: window miscall mass over the
                # full read length
                miscalls = (
                    -qual_window.astype(np.float64) * math.log(10.0) / 10.0
                )
                with np.errstate(divide="ignore"):
                    error_rate = (
                        float(
                            np.log(np.sum(np.exp(miscalls)))
                            - math.log(max(record.read_len, 1))
                        )
                        if len(miscalls)
                        else LOG_ZERO
                    )
                out.append((region, read_window, qual_window, error_rate))
        if key is not None:
            memo[key] = out
        return out

    def allele_support(self, record, loci, variant, alt_variants, props):
        """realignment/mod.rs:161-423.  loci: [(start, end)] on variant contig."""
        preamble = self._region_preamble(
            record, loci, self.reference.contig_length(variant.contig)
        )
        if preamble is None:
            p = math.log(0.5)
            return AlleleSupport(prob_ref=p, prob_alt=p, strand=STRAND_NONE)

        ref_seq = self.reference.seq(variant.contig)
        prob_ref_all = 0.0
        prob_alt_all = 0.0
        strand = STRAND_NONE
        homopolymer_indel_len = None
        is_third_allele = False
        alt_edit_dist = None

        for region, read_window, qual_window, error_rate in preamble:

            em_memo = self._em_memo
            em_key = (
                (id(variant), tuple(id(v) for v in alt_variants), region.ref_start, region.ref_end)
                if em_memo is not None
                else None
            )
            cached_em = em_memo.get(em_key) if em_memo is not None else None
            if cached_em is not None:
                ref_alleles, alt_alleles = cached_em
            else:
                ref_alleles = [
                    AlleleEmission(
                        seq=bytes(ref_seq[region.ref_start : region.ref_end]),
                        ref_offset=region.ref_start,
                    )
                ]
                for av in alt_variants:
                    ref_alleles.extend(
                        av.alt_emission_params(
                            ref_seq, region.ref_start, region.ref_end, self.ref_window
                        )
                    )
                alt_alleles = variant.alt_emission_params(
                    ref_seq, region.ref_start, region.ref_end, self.ref_window
                )
                if em_memo is not None:
                    em_memo[em_key] = (ref_alleles, alt_alleles)

            all_emissions = ref_alleles + alt_alleles
            hits = self._calc_hits(all_emissions, read_window, props, error_rate)
            n_ref = len(ref_alleles)

            # DELIBERATE DIVERGENCE from prob_allele
            # (realignment/mod.rs:426-479): the reference preselects the
            # allele(s) with minimal Myers edit distance per set and only
            # runs the pair HMM on those; we run the (banded) HMM on every
            # candidate and take the max probability per set.  Our
            # breakend-assembly windows differ from the reference's at
            # single-base granularity, which makes min-dist ties between
            # near-identical alleles (e.g. a DUP's junction allele vs its
            # ref-like dummy antisense allele) unstable - preselection then
            # drops genuinely supporting reads (test44 loses half its
            # informative pileup).  Probability subsumes the edit distance
            # signal; each HMM run is still banded to its OWN hit's
            # dist + EDIT_BAND (dist_upper_bound, edit_distance.rs:493-497).
            if self.mode == "fast":
                # fast mode: score the edit-distance path only
                probs = np.array(
                    [
                        path_score(h.ops, read_window, qual_window, self.hmm.gap)
                        if h is not None
                        else math.log(0.5)
                        for h in hits
                    ]
                )
            else:
                probs = self._forward_alleles(
                    all_emissions, hits, read_window, qual_window, props,
                    error_rate, n_ref,
                )
            if _PARITY_PRESELECT:
                # reference prob_allele (mod.rs:426-479): only alleles whose
                # Myers edit distance is minimal within their set are eligible;
                # the HMM prob breaks ties. (The batched forward still runs on
                # every allele to keep the record/replay call sequence stable;
                # preselection only gates which result is used.)
                def _select(sub_hits, sub_probs):
                    dists = [h.dist if h is not None else None for h in sub_hits]
                    valid = [i for i, d in enumerate(dists) if d is not None]
                    if valid:
                        mind = min(dists[i] for i in valid)
                        elig = [i for i in valid if dists[i] == mind]
                    else:
                        elig = list(range(len(sub_hits)))
                    return max(elig, key=lambda i: sub_probs[i])

                ref_idx = _select(hits[:n_ref], probs[:n_ref])
                alt_rel = _select(hits[n_ref:], probs[n_ref:])
            else:
                # single-allele sets (the common case) skip the argmax
                n_alt = len(probs) - n_ref
                ref_idx = 0 if n_ref == 1 else int(np.argmax(probs[:n_ref]))
                alt_rel = 0 if n_alt == 1 else int(np.argmax(probs[n_ref:]))
            prob_ref = float(probs[ref_idx])
            prob_alt = float(probs[n_ref + alt_rel])
            alt_emission = alt_alleles[alt_rel]
            alt_hit = hits[n_ref + alt_rel]

            # third-allele rescue (realignment/mod.rs:317-348). The reference
            # fires on prob_alt > prob_ref strictly; when both alleles are
            # terrible (e.g. a read carrying an unrelated indel) the two sides
            # are near-tied and the tie direction is numerical noise, so we
            # allow a small epsilon — semantically the read comes from a third
            # allele either way, and the patched-allele check below still
            # guards the replacement.
            # NOTE: the patched-allele forwards are computed for EVERY alt
            # allele from host-side edit-distance state only — during the
            # record pass `probs` is an all-zeros stub, so anything derived
            # from argmax(probs) (which alt wins) would differ between the
            # record and replay passes and desynchronize the batched-forward
            # cursor. Queuing the superset keeps the forward-call sequence
            # bitwise identical across passes; the HMM-prob gate below only
            # decides whether the SELECTED alt's result is used.
            p_inferred_by_alt: list[float | None] = []
            for a_em, a_hit in zip(alt_alleles, hits[n_ref:]):
                p_inf = None
                # METHOD (same-length skip inside _patched_window): for an
                # indel variant, a read-derived allele of the SAME length as
                # the candidate allele means the read carries an indel of
                # identical length at this locus — the same event; rescue is
                # kept for length-changing patches only.
                patched, phit = self._patched_window(
                    a_em, a_hit, read_window, props, error_rate
                )
                if patched is not None:
                    lo = max(phit.start - EDIT_BAND, 0)
                    hi = min(phit.end + EDIT_BAND, len(patched))
                    if self.mode == "fast":
                        p_inf = path_score(
                            phit.ops, read_window, qual_window, self.hmm.gap
                        )
                    else:
                        p_inf = float(
                            self._forward(
                                [patched[lo:hi]],
                                [read_window],
                                [qual_window],
                                [phit.dist + EDIT_BAND],
                            )[0]
                        )
                p_inferred_by_alt.append(p_inf)
            p_inferred = p_inferred_by_alt[alt_rel]
            if p_inferred is not None:
                eps = 0.0 if _PARITY_PRESELECT else 1.0
                if prob_alt > prob_ref - eps and p_inferred > prob_ref:
                    prob_ref = p_inferred
                    is_third_allele = True

            # normalization: only the ratio matters (mod.rs:350-376)
            if prob_ref > LOG_ZERO and prob_alt > LOG_ZERO:
                total = np_ln_add_exp(prob_ref, prob_alt)
                prob_ref -= total
                prob_alt -= total
            if prob_ref == LOG_ZERO and prob_alt == LOG_ZERO:
                prob_ref = prob_alt = math.log(0.5)

            if prob_ref != prob_alt:
                # per-base SI aux strand info: OR the strands over this
                # region's read interval (realignment/mod.rs:380-388); the
                # FLAG-based fallback below fires only when SI is absent
                si = record.tags.get("SI")
                if isinstance(si, str):
                    from .observation import (
                        STRAND_FORWARD as _SF,
                        STRAND_REVERSE as _SR,
                    )

                    for c in si[region.read_start : region.read_end]:
                        strand |= {"+": _SF, "-": _SR, "*": _SF | _SR}.get(
                            c, 0
                        )
                if homopolymer_indel_len is None and alt_hit is not None:
                    homopolymer_indel_len = alt_hit.homopolymer_indel_len

            if alt_hit is not None and alt_hit.explainable is not None:
                d = alt_hit.in_range_dist
                alt_edit_dist = d if alt_edit_dist is None else alt_edit_dist + d

            prob_ref_all += prob_ref
            prob_alt_all += prob_alt

        if record.tags.get("SI") is None and prob_ref_all != prob_alt_all:
            # no per-base strand info: whole-record FLAG strand
            # (realignment/mod.rs:405-409)
            strand = strand_from_record(record)

        return AlleleSupport(
            prob_ref=prob_ref_all,
            prob_alt=prob_alt_all,
            strand=strand,
            homopolymer_indel_len=homopolymer_indel_len,
            third_allele_evidence=alt_edit_dist if is_third_allele else None,
        )
