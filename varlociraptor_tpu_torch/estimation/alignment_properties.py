"""Alignment properties: insert-size stats, CIGAR extrema, error-model params.

Mirrors the reference's ``AlignmentProperties``
(``src/estimation/alignment_properties.rs:58-79``) including its
JSON serialization (testcase ``properties`` strings round-trip).  Estimation
from BAM (``estimate()``, reference ``alignment_properties.rs:148-465``) is
implemented in numpy over the first N records.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np

LOG_ZERO = -math.inf


def _logprob_from_rate(rate: float) -> float:
    return math.log(rate) if rate > 0 else LOG_ZERO


@dataclass
class InsertSize:
    mean: float = 0.0
    sd: float = 0.0


@dataclass
class GapParams:
    """PairHMM gap open/extend log-probabilities
    (reference pairhmm.rs:122-142; defaults ins 2.8e-6 / del 5.1e-6)."""

    prob_insertion_artifact: float = math.log(2.8e-6)
    prob_deletion_artifact: float = math.log(5.1e-6)
    prob_insertion_extend_artifact: float = LOG_ZERO
    prob_deletion_extend_artifact: float = LOG_ZERO


@dataclass
class HopParams:
    """Homopolymer hop log-probs per base (A,C,G,T) for the homopolymer
    pair-HMM (reference pairhmm.rs:208-294)."""

    prob_seq_homopolymer: list = field(default_factory=lambda: [LOG_ZERO] * 4)
    prob_ref_homopolymer: list = field(default_factory=lambda: [LOG_ZERO] * 4)
    prob_seq_extend_homopolymer: list = field(default_factory=lambda: [LOG_ZERO] * 4)
    prob_ref_extend_homopolymer: list = field(default_factory=lambda: [LOG_ZERO] * 4)


def _default_homopolymer_error_model():
    # BackwardsCompatibility::default_homopolymer_error_model
    # (alignment_properties.rs:39-50)
    return {
        0: 0.9975414130829068,
        1: 0.0010076175889726332,
        -1: 0.0010076175889726332,
        -2: 0.00020152351779452663,
        2: 0.00010076175889726332,
        3: 5.038087944863166e-5,
        -3: 9.068558300753699e-5,
    }


@dataclass
class AlignmentProperties:
    insert_size: InsertSize | None = None
    max_del_cigar_len: int | None = None
    max_ins_cigar_len: int | None = None
    frac_max_softclip: float | None = None
    max_read_len: int = 100
    max_mapq: int = 60
    gap_params: GapParams = field(default_factory=GapParams)
    hop_params: HopParams = field(default_factory=HopParams)
    wildtype_homopolymer_error_model: dict = field(
        default_factory=_default_homopolymer_error_model
    )
    initial: bool = False

    # ------------------------------------------------------------------
    @classmethod
    def from_json(cls, text: str) -> "AlignmentProperties":
        d = json.loads(text)
        props = cls()
        if d.get("insert_size") is not None:
            props.insert_size = InsertSize(
                mean=d["insert_size"]["mean"], sd=d["insert_size"]["sd"]
            )
        props.max_del_cigar_len = d.get("max_del_cigar_len")
        props.max_ins_cigar_len = d.get("max_ins_cigar_len")
        props.frac_max_softclip = d.get("frac_max_softclip")
        props.max_read_len = d.get("max_read_len", 100)
        props.max_mapq = d.get("max_mapq", 60)
        if "gap_params" in d and d["gap_params"] is not None:
            g = d["gap_params"]

            def lp(v):
                return v if v is not None else LOG_ZERO

            props.gap_params = GapParams(
                prob_insertion_artifact=lp(g.get("prob_insertion_artifact")),
                prob_deletion_artifact=lp(g.get("prob_deletion_artifact")),
                prob_insertion_extend_artifact=lp(g.get("prob_insertion_extend_artifact")),
                prob_deletion_extend_artifact=lp(g.get("prob_deletion_extend_artifact")),
            )
        if "hop_params" in d and d["hop_params"] is not None:
            h = d["hop_params"]

            def lpv(v):
                return [x if x is not None else LOG_ZERO for x in v]

            props.hop_params = HopParams(
                prob_seq_homopolymer=lpv(h["prob_seq_homopolymer"]),
                prob_ref_homopolymer=lpv(h["prob_ref_homopolymer"]),
                prob_seq_extend_homopolymer=lpv(h["prob_seq_extend_homopolymer"]),
                prob_ref_extend_homopolymer=lpv(h["prob_ref_extend_homopolymer"]),
            )
        if "wildtype_homopolymer_error_model" in d:
            props.wildtype_homopolymer_error_model = {
                int(k): v for k, v in d["wildtype_homopolymer_error_model"].items()
            }
        return props

    def to_json(self) -> str:
        def lp(v):
            return None if v == LOG_ZERO else v

        return json.dumps(
            {
                "insert_size": (
                    {"mean": self.insert_size.mean, "sd": self.insert_size.sd}
                    if self.insert_size
                    else None
                ),
                "max_del_cigar_len": self.max_del_cigar_len,
                "max_ins_cigar_len": self.max_ins_cigar_len,
                "frac_max_softclip": self.frac_max_softclip,
                "max_read_len": self.max_read_len,
                "max_mapq": self.max_mapq,
                "gap_params": {
                    "prob_insertion_artifact": lp(self.gap_params.prob_insertion_artifact),
                    "prob_deletion_artifact": lp(self.gap_params.prob_deletion_artifact),
                    "prob_insertion_extend_artifact": lp(
                        self.gap_params.prob_insertion_extend_artifact
                    ),
                    "prob_deletion_extend_artifact": lp(
                        self.gap_params.prob_deletion_extend_artifact
                    ),
                },
                "hop_params": {
                    "prob_seq_homopolymer": [lp(x) for x in self.hop_params.prob_seq_homopolymer],
                    "prob_ref_homopolymer": [lp(x) for x in self.hop_params.prob_ref_homopolymer],
                    "prob_seq_extend_homopolymer": [
                        lp(x) for x in self.hop_params.prob_seq_extend_homopolymer
                    ],
                    "prob_ref_extend_homopolymer": [
                        lp(x) for x in self.hop_params.prob_ref_extend_homopolymer
                    ],
                },
                "wildtype_homopolymer_error_model": {
                    str(k): v for k, v in self.wildtype_homopolymer_error_model.items()
                },
            }
        )

    # ------------------------------------------------------------------
    def update_max_cigar_ops_len(self, record, allow_hardclips: bool = False):
        """Continuously track maxima while preprocessing
        (alignment_properties.rs:94-144)."""
        from ..io.bam import OP_D, OP_H, OP_I, OP_S

        # the same record is seen by many overlapping locus fetches; the
        # max-updates are idempotent per record, so cache the result on it
        cached = getattr(record, "_cig_maxes", None)
        if cached is not None and cached[0] == allow_hardclips:
            return cached[1], cached[2]

        is_regular = True
        has_soft_clip = False
        read_len = max(record.read_len, 1)
        for op, l in record.cigar:
            if op == OP_S:
                frac = l / read_len
                if self.frac_max_softclip is not None:
                    self.frac_max_softclip = max(self.frac_max_softclip, frac)
                elif self.initial:
                    self.frac_max_softclip = frac
                is_regular = False
                has_soft_clip = True
            elif op == OP_D:
                if self.max_del_cigar_len is not None:
                    self.max_del_cigar_len = max(self.max_del_cigar_len, int(l))
                elif self.initial:
                    self.max_del_cigar_len = int(l)
                is_regular = False
            elif op == OP_I:
                if self.max_ins_cigar_len is not None:
                    self.max_ins_cigar_len = max(self.max_ins_cigar_len, int(l))
                elif self.initial:
                    self.max_ins_cigar_len = int(l)
                is_regular = False
            elif op == OP_H and not allow_hardclips:
                is_regular = False
        object.__setattr__(
            record, "_cig_maxes", (allow_hardclips, is_regular, has_soft_clip)
        )
        return is_regular, has_soft_clip


# 15-state transition model (alignment_properties.rs:535-560)
MATCH_A, MATCH_C, MATCH_G, MATCH_T = 0, 1, 2, 3
GAP_X, GAP_Y = 4, 5
HOP_X = {65: 6, 67: 8, 71: 10, 84: 12}  # HopAX..HopTX by ref base
HOP_Y = {65: 7, 67: 9, 71: 11, 84: 13}
OTHER = 14
N_STATES = 15
_MATCH = {65: MATCH_A, 67: MATCH_C, 71: MATCH_G, 84: MATCH_T}
MIN_HOMOPOLYMER_LEN = 2

_STATE_LUT = np.full(256, OTHER, dtype=np.int64)
for _b, _s in _MATCH.items():
    _STATE_LUT[_b] = _s
    _STATE_LUT[_b | 0x20] = _s
_ACGT = np.zeros(256, dtype=bool)
for _b in (65, 67, 71, 84):
    _ACGT[_b] = True


def _match_state(base):
    return _MATCH.get(int(base) & ~0x20, OTHER)


def _is_homopolymer(arr):
    return len(arr) > 0 and len(set(int(x) & ~0x20 for x in arr)) == 1


def _extend_stretch(base, seq):
    """Length of the case-insensitive run of ``base`` at the head of seq
    (chunked vectorized scan — ``seq`` may be a whole-contig tail)."""
    b = int(base) & ~0x20
    n = 0
    total = len(seq)
    while n < total:
        chunk = np.asarray(seq[n : n + 4096], dtype=np.uint8) & np.uint8(0xDF)
        ne = chunk != b
        if ne.any():
            return n + int(np.argmax(ne))
        n += len(chunk)
    return n


def cigar_stats(record, refseq, transitions, hop_counts, m_chains=None,
                ref_states=None, ref_up=None, h_parts=None):
    """Accumulate 15-state transition counts + homopolymer hop histogram for
    one record (alignment_properties.rs:693-860).

    ``m_chains``: optional list — when given, match-segment state chains are
    APPENDED instead of scattered into ``transitions`` per record (the
    estimate() loop finalizes them with one ``np.add.at`` over the whole
    pass; per-record ``np.add.at`` dominated the estimator at ~60 us/record).
    ``ref_states``/``ref_up``: optional whole-contig precomputed
    ``_STATE_LUT[refseq]`` / ``refseq & 0xDF`` arrays — turns the per-record
    M-arm LUT gathers into zero-copy views.  ``h_parts``: optional list —
    per-record (upper-ref, match-ok) homopolymer segments are APPENDED and
    finalized by estimate() in one run-length pass over the whole BAM
    (same batching idea as ``m_chains``)."""
    from ..io.bam import OP_D, OP_EQ, OP_I, OP_M, OP_N, OP_S, OP_X

    qseq = record.seq
    qpos = 0
    rpos = record.pos
    for op, l in record.cigar:
        l = int(l)
        if op == OP_D:
            if l < 32767 and rpos + l <= len(refseq):
                base = int(refseq[rpos])
                seg = refseq[rpos : rpos + l]
                homo = _is_homopolymer(seg)
                if homo:
                    length = l
                    if rpos + l < len(refseq):
                        length += _extend_stretch(base, refseq[rpos + l :])
                    if rpos > 1:
                        length += _extend_stretch(base, refseq[: rpos - 1][::-1])
                    if length >= MIN_HOMOPOLYMER_LEN and base in HOP_X:
                        ms = _match_state(base)
                        hs = HOP_X[base]
                        transitions[ms, ms] += l
                        transitions[ms, hs] += 1
                        transitions[hs, hs] += max(0, length - max(0, l - 2))
                        if rpos + length + 1 < len(refseq):
                            transitions[hs, _match_state(refseq[rpos + length + 1])] += 1
                        hop_counts.setdefault(base, {}).setdefault((length, length - l), 0)
                        hop_counts[base][(length, length - l)] += 1
                if not homo or l == 1:
                    transitions[_match_state(base), GAP_X] += 1
                    transitions[GAP_X, GAP_X] += max(0, l - 2)
                    if rpos + l + 1 < len(refseq):
                        transitions[GAP_X, _match_state(refseq[rpos + l + 1])] += 1
            rpos += l
        elif op == OP_I:
            if l < 32767 and qpos + l <= len(qseq) and rpos < len(refseq):
                rbase = int(refseq[rpos])
                qbase = int(qseq[qpos])
                base = rbase if (rbase & ~0x20) == (qbase & ~0x20) else qbase
                homo = _is_homopolymer(qseq[qpos : qpos + l])
                if homo:
                    length = l + _extend_stretch(qseq[qpos], refseq[rpos:])
                    if rpos > 0:
                        length += _extend_stretch(qseq[qpos], refseq[:rpos][::-1])
                    if length >= MIN_HOMOPOLYMER_LEN and (base & ~0x20) in HOP_Y:
                        b = base & ~0x20
                        ms = _match_state(b)
                        hs = HOP_Y[b]
                        transitions[ms, ms] += l
                        transitions[ms, hs] += 1
                        transitions[hs, hs] += max(0, length - max(0, l - 2))
                        if rpos + 1 < len(refseq):
                            transitions[hs, _match_state(refseq[rpos + 1])] += 1
                        hop_counts.setdefault(b, {}).setdefault((length - l, l), 0)
                        hop_counts[b][(length - l, l)] += 1
                if not homo or l == 1:
                    b = base & ~0x20
                    transitions[_match_state(b), GAP_Y] += 1
                    transitions[GAP_Y, GAP_Y] += max(0, l - 2)
                    if rpos + l + 1 < len(refseq):
                        transitions[GAP_Y, _match_state(refseq[rpos + l + 1])] += 1
            qpos += l
        elif op in (OP_M, OP_EQ, OP_X):
            end = min(rpos + l, len(refseq))
            # match-state chain transitions (vectorized)
            if ref_states is not None:
                st = ref_states[rpos:end]
            else:
                st = _STATE_LUT[np.asarray(refseq[rpos:end], dtype=np.uint8)]
            if len(st) > 1:
                if m_chains is not None:
                    m_chains.append(st)
                else:
                    np.add.at(transitions, (st[:-1], st[1:]), 1)
            # error-free homopolymer stretches (hop_counts diagonal)
            m = min(end - rpos, len(qseq) - qpos)
            if m >= MIN_HOMOPOLYMER_LEN:
                if ref_up is not None:
                    up = ref_up[rpos : rpos + m]
                else:
                    up = np.asarray(refseq[rpos : rpos + m], dtype=np.uint8) & 0xDF
                ok = (
                    (np.asarray(qseq[qpos : qpos + m], dtype=np.uint8) & 0xDF)
                    == up
                ) & _ACGT[up]
                if h_parts is not None:
                    h_parts.append((up, ok))
                else:
                    brk = (
                        np.nonzero((up[1:] != up[:-1]) | (ok[1:] != ok[:-1]))[0]
                        + 1
                    )
                    starts = np.concatenate(([0], brk))
                    stops = np.concatenate((brk, [m]))
                    runs = stops - starts
                    sel = ok[starts] & (runs >= MIN_HOMOPOLYMER_LEN)
                    if sel.any():
                        key = up[starts[sel]].astype(np.int64) * 65536 + runs[sel]
                        uk, cnt = np.unique(key, return_counts=True)
                        for k2, c2 in zip(uk.tolist(), cnt.tolist()):
                            b, run = k2 >> 16, k2 & 0xFFFF
                            d = hop_counts.setdefault(b, {})
                            d[(run, run)] = d.get((run, run), 0) + c2
            qpos += l
            rpos += l
        elif op == OP_S:
            qpos += l
        elif op == OP_N:
            rpos += l


def estimate_gap_params(transitions) -> GapParams | None:
    """MLE gap params from transition counts
    (alignment_properties.rs:864-920). None if insufficient counts."""
    matches = [MATCH_A, MATCH_C, MATCH_G, MATCH_T]
    out = []
    for gap in (GAP_X, GAP_Y):
        from_match_to_gap = sum(transitions[m, gap] for m in matches)
        extend_gap = transitions[gap, gap]
        if from_match_to_gap < 100 or extend_gap < 100:
            return None
        from_gap = transitions[gap].sum()
        from_match = sum(transitions[m].sum() for m in matches)
        prob_start = from_match_to_gap / max(from_match, 1)
        prob_extend = extend_gap / max(from_gap, 1)
        out.append((_logprob_from_rate(prob_start), _logprob_from_rate(prob_extend)))
    # reference destructuring (alignment_properties.rs:868-870): the
    # GapX-derived rates (accumulated from Cigar::Del) become the
    # INSERTION params and GapY-derived (Cigar::Ins) the DELETION params —
    # the pair-HMM's x/y gap axes are named from the reference sequence's
    # perspective, opposite to the CIGAR's read-centric naming
    (ins_open, ins_ext), (del_open, del_ext) = out
    return GapParams(
        prob_insertion_artifact=ins_open,
        prob_deletion_artifact=del_open,
        prob_insertion_extend_artifact=ins_ext,
        prob_deletion_extend_artifact=del_ext,
    )


def estimate_hop_params(transitions) -> HopParams | None:
    """MLE hop params (alignment_properties.rs:923-972)."""
    seq_h, ref_h, seq_e, ref_e = [], [], [], []
    for base in (65, 67, 71, 84):
        m = _match_state(base)
        vals = []
        for hop in (HOP_X[base], HOP_Y[base]):
            start = transitions[m, hop]
            extend = transitions[hop, hop]
            if start + extend < 100:
                return None
            from_prev = transitions[m].sum()
            vals.append(_logprob_from_rate((start + extend) / max(from_prev, 1)))
        ins_p, del_p = vals
        seq_h.append(ins_p)
        ref_h.append(del_p)
        seq_e.append(ins_p)
        ref_e.append(del_p)
    return HopParams(
        prob_seq_homopolymer=seq_h,
        prob_ref_homopolymer=ref_h,
        prob_seq_extend_homopolymer=seq_e,
        prob_ref_extend_homopolymer=ref_e,
    )


def wildtype_homopolymer_error_model(hop_counts) -> dict | None:
    """alignment_properties.rs:974-1010: indel-length histogram of
    homopolymer stretches."""
    n = sum(
        c for counter in hop_counts.values() for c in counter.values() if c >= 10
    )
    if n == 0:
        return None
    grouped: dict[int, int] = {}
    for counter in hop_counts.values():
        for (a, b), c in counter.items():
            length = int(a) - int(b)
            grouped[length] = grouped.get(length, 0) + c
    return {k: v / n for k, v in grouped.items()}


def min_alignments_for_hphmm_mle(
    num_alignments: int | None,
    precision: float = 1e-5,
    precision_is_relative: bool = True,
    confidence_level: float = 0.1,
) -> int:
    """Chi-squared sample-size bound for the hop-HMM transition MLE
    (``alignment_properties.rs:466-533``): the number of alignments needed
    to estimate every transition probability to ``precision`` at
    ``confidence_level``, with the finite-population correction when the
    BAM's total mapped count is known from the index.

    Formula from Krejcie & Morgan-style chi-squared sizing
    (jstor.org/stable/2683352), 82 valid transitions, ~100 transitions per
    alignment, checked on probabilities {0.25, 1e-1..1e-5}.
    """
    from statistics import NormalDist

    transitions_per_alignment = 100.0
    n_valid_transitions = 82
    p_chi = 1.0 - confidence_level / n_valid_transitions
    # chi^2(1 dof) quantile via the normal quantile: X = Z^2
    b = NormalDist().inv_cdf((p_chi + 1.0) / 2.0) ** 2
    probs = [0.25, 1e-1, 1e-2, 1e-3, 1e-4, 1e-5]
    needed = []
    for p in probs:
        p_ = precision * p if precision_is_relative else precision
        if num_alignments:
            n_trans = num_alignments * transitions_per_alignment
            est = (
                b * n_trans * p * (1.0 - p)
                / (p_ ** 2 * (n_trans - 1.0) + b * p * (1.0 - p))
            ) / transitions_per_alignment
        else:
            est = (b * p * (1.0 - p) / p_ ** 2) / transitions_per_alignment
        needed.append(math.ceil(est))
    return max(needed)


def estimate(
    bam_reader,
    omit_insert_size: bool = False,
    num_records: int | None = None,
    reference=None,
):
    """Estimate alignment properties from the first records of a BAM.

    Behaviorally matching estimator (reference
    ``alignment_properties.rs:148-465``): 5-95 percentile-trimmed insert-size
    mean/sd over proper pairs, CIGAR maxima, max read len, max MAPQ observed.
    When a reference ``FastaBuffer`` is supplied, the 15-state transition
    counts are accumulated and gap/hop params + the wildtype homopolymer
    error model are MLE-estimated (``alignment_properties.rs:535-1010``);
    insufficient counts fall back to the defaults, like the reference.
    """
    props = AlignmentProperties(initial=True)
    props.max_del_cigar_len = None
    props.max_ins_cigar_len = None
    props.frac_max_softclip = None

    tlens = []
    max_read_len = 0
    max_mapq = 0
    n = 0
    if num_records is not None:
        n_records = num_records
    else:
        # precision-driven stopping rule (alignment_properties.rs:252-273):
        # the chi-squared bound, fpc-corrected by the index's total mapped
        # count when available
        mapped = None
        try:
            from ..io.bam_index import BamIndex

            idx = BamIndex.load(getattr(bam_reader, "path", None))
            if idx is not None:
                mapped = idx.mapped_total()
        except Exception:  # noqa: BLE001 - index is optional
            mapped = None
        n_records = min_alignments_for_hphmm_mle(mapped)
    transitions = np.zeros((N_STATES, N_STATES), dtype=np.int64)
    hop_counts: dict[int, dict[tuple, int]] = {}
    m_chains: list = []
    h_parts: list = []
    ref_cache: dict[int, np.ndarray] = {}
    ref_state_cache: dict[int, np.ndarray] = {}
    ref_up_cache: dict[int, np.ndarray] = {}
    allow_hardclips = omit_insert_size  # alignment_properties.rs:156
    for rec in bam_reader:
        # skip condition: alignment_properties.rs:294-299 (note mapq==0)
        if (
            rec.mapq == 0
            or rec.is_unmapped
            or rec.is_duplicate
            or rec.is_qc_fail
            or rec.read_len == 0
        ):
            continue
        n += 1
        if n > n_records:
            break
        max_read_len = max(max_read_len, rec.read_len)
        max_mapq = max(max_mapq, rec.mapq)
        is_regular, _ = props.update_max_cigar_ops_len(rec, allow_hardclips)
        if reference is not None and rec.tid >= 0:
            if rec.tid not in ref_cache:
                try:
                    ref_cache[rec.tid] = reference.seq(bam_reader.ref_names[rec.tid])
                except KeyError:
                    ref_cache[rec.tid] = None
                seq = ref_cache[rec.tid]
                if seq is not None:
                    arr = np.asarray(seq, dtype=np.uint8)
                    ref_state_cache[rec.tid] = _STATE_LUT[arr]
                    ref_up_cache[rec.tid] = arr & 0xDF
            refseq = ref_cache[rec.tid]
            if refseq is not None:
                cigar_stats(
                    rec, refseq, transitions, hop_counts, m_chains,
                    ref_states=ref_state_cache[rec.tid],
                    ref_up=ref_up_cache[rec.tid],
                    h_parts=h_parts,
                )
        # insert size only from regular, first-in-template proper records
        # (alignment_properties.rs:318-338)
        if (
            not omit_insert_size
            and is_regular
            and rec.is_paired
            and rec.is_first_in_pair
            and not rec.is_mate_unmapped
            and rec.tid == rec.mtid
        ):
            tlens.append(abs(rec.tlen))

    if m_chains:
        # one scatter-add for the whole pass; a 16th sentinel state between
        # records keeps cross-record pairs out of the 15x15 block
        sep = np.array([N_STATES], dtype=np.int64)
        cat = np.concatenate(
            [x for c in m_chains for x in (c, sep)][:-1]
        )
        scratch = np.zeros((N_STATES + 1, N_STATES + 1), dtype=np.int64)
        np.add.at(scratch, (cat[:-1], cat[1:]), 1)
        transitions += scratch[:N_STATES, :N_STATES]
    if h_parts:
        # one run-length pass for all per-record homopolymer segments; a
        # (0, False) sentinel between records keeps runs from spanning them
        # (up=0 is non-ACGT, so sentinel runs never pass `sel`)
        sep_u = np.zeros(1, dtype=np.uint8)
        sep_o = np.zeros(1, dtype=bool)
        ups, oks = [], []
        for u, o in h_parts:
            ups.append(u)
            ups.append(sep_u)
            oks.append(o)
            oks.append(sep_o)
        up = np.concatenate(ups[:-1])
        ok = np.concatenate(oks[:-1])
        brk = np.nonzero((up[1:] != up[:-1]) | (ok[1:] != ok[:-1]))[0] + 1
        starts = np.concatenate(([0], brk))
        stops = np.concatenate((brk, [len(up)]))
        runs = stops - starts
        sel = ok[starts] & (runs >= MIN_HOMOPOLYMER_LEN)
        if sel.any():
            key = up[starts[sel]].astype(np.int64) * 65536 + runs[sel]
            uk, cnt = np.unique(key, return_counts=True)
            for k2, c2 in zip(uk.tolist(), cnt.tolist()):
                b, run = k2 >> 16, k2 & 0xFFFF
                d = hop_counts.setdefault(b, {})
                d[(run, run)] = d.get((run, run), 0) + c2
    props.initial = False
    props.max_read_len = max(max_read_len, 1)
    props.max_mapq = max_mapq
    if tlens and not omit_insert_size:
        arr = np.array(tlens, dtype=np.float64)
        lo, hi = np.percentile(arr, [5.0, 95.0])
        trimmed = arr[(arr >= lo) & (arr <= hi)]
        if len(trimmed) >= 2:
            props.insert_size = InsertSize(
                mean=float(np.mean(trimmed)), sd=float(np.std(trimmed, ddof=1))
            )
    if reference is not None:
        gp = estimate_gap_params(transitions)
        if gp is not None:
            props.gap_params = gp
        hp = estimate_hop_params(transitions)
        if hp is not None:
            props.hop_params = hp
        model = wildtype_homopolymer_error_model(hop_counts)
        if model is not None:
            props.wildtype_homopolymer_error_model = model
    return props
