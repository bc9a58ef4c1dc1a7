"""Edit-distance engine: semiglobal alignment, third-allele rescue,
homopolymer indel extraction.

Re-implements ``src/variants/evidence/realignment/edit_distance.rs``:
best-hit semiglobal edit alignment of the read window against an allele
window.  Like the reference we use Myers bit-parallel (u128, reads up to
128bp — ``native/vlt_native.cpp:vlt_myers_semiglobal``) to locate the
first/last co-optimal end columns on LONG allele windows, then run the
native O(nm) traceback DP only on the hit windows
(``io/native.py:semiglobal_edit_hybrid``); short windows go straight to
the DP, which is already cheaper there (~6% of total preprocess
wall-time at 2000-locus scale).  Per-allele edit-operation counts
restricted to the variant's ref range, the "explainable by error rates"
classification, read-derived ("third") allele patching
(``edit_distance.rs:360-467``), and the homopolymer indel operation
(``src/utils/homopolymers.rs:53-160``).
"""

from __future__ import annotations

import math
import os as _os
from dataclasses import dataclass, field

import numpy as np

_PARITY_DEL = _os.environ.get("VLT_PRESELECT", "0") == "1"

EDIT_BAND = 4  # pairhmm.rs:21

M, S, I, D = 0, 1, 2, 3  # match, subst, ins (read base), del (allele base)


@dataclass
class EditHit:
    dist: int
    start: int  # allele index of alignment start
    end: int  # allele-window upper bound for banding (start of last + len + dist)
    ops: list  # [(op, ...)] traceback ops, allele-axis leftmost alignment
    n_subst_in_range: int = 0
    n_ins_in_range: int = 0
    n_del_in_range: int = 0
    explainable: bool | None = None
    homopolymer_indel_len: int | None = None
    # alignment whose edit-operation counts won the co-optimal-placement
    # comparison (edit_distance.rs some_alignment: the reference patches
    # the allele from the MIN-counts alignment, not always the first)
    range_start: int | None = None
    range_ops: list | None = None

    @property
    def in_range_dist(self):
        return self.n_subst_in_range + self.n_ins_in_range + self.n_del_in_range


_W = 4096  # primary edit weight; secondary (in-range) tie-break fits below


def semiglobal_edit(
    allele: np.ndarray,
    read: np.ndarray,
    in_range: np.ndarray | None = None,
    with_last: bool = False,
) -> tuple:
    """Edit distance of `read` against any substring-anchored placement in
    `allele` (free start/end on allele axis). Returns (dist, start, ops),
    or (dist, start, ops, last_start) when ``with_last`` — last_start being
    the traceback start of the LAST co-optimal end position (the reference's
    hit window spans all co-optimal placements, edit_distance.rs:225-240).

    ``in_range`` (optional, bool per allele position) lexicographically
    tie-breaks among co-optimal alignments toward the one with the FEWEST
    edit operations inside the variant ref range. This mirrors the
    reference's ``.min()`` over all Myers co-optimal alignments
    (edit_distance.rs:246-301 with EditOperationCounts::cmp), which
    prevents spurious third-allele rescues when an equally good alignment
    places the edits outside the variant.
    """
    if in_range is None:
        from ..io import native

        res = native.semiglobal_edit_hybrid(bytes(allele), bytes(read))
        if res is not None:
            return res if with_last else res[:3]
    a = np.frombuffer(bytes(allele), dtype=np.uint8) & ~np.uint8(0x20)
    r = np.frombuffer(bytes(read), dtype=np.uint8) & ~np.uint8(0x20)
    X, Y = len(a), len(r)
    if in_range is None:
        sub_w = np.full(X, _W, dtype=np.int32)
        ins_w = np.full(X + 1, _W, dtype=np.int32)
    else:
        ir = np.asarray(in_range, dtype=np.int32)
        sub_w = _W + ir  # S/D consuming allele char i
        ins_w = np.full(X + 1, _W, dtype=np.int32)
        ins_w[:X] += ir  # I at allele position i (before consuming a[i])
    # dp[j] over read axis; iterate allele columns; free start: dp row j=0 is 0
    # at every column. We need full matrix for traceback: keep it (X+1, Y+1).
    dp = np.zeros((X + 1, Y + 1), dtype=np.int32)
    dp[:, 0] = 0  # free start gap in allele
    ar = np.arange(Y + 1, dtype=np.int32)
    dp[0, :] = ar * ins_w[0]  # leading read bases must be inserted
    for i in range(1, X + 1):
        w = sub_w[i - 1]
        sub = dp[i - 1, :-1] + np.where(a[i - 1] != r, w, 0)
        cand = np.minimum(sub, dp[i - 1, 1:] + w)  # subst/match | del (allele)
        row = dp[i]
        row[1:] = cand  # row[0] stays 0 (free start gap in allele)
        # insertions (read bases): row[j] = min_{k<=j} row[k] + (j-k)*iw, via
        # the min-prefix trick on (row - j*iw); iw constant within the row
        iw = ins_w[i]
        t = row - ar * iw
        np.minimum.accumulate(t, out=t)
        dp[i] = t + ar * iw
    # best end: min over dp[i, Y]
    ends = dp[:, Y]
    best_i = int(np.argmin(ends))
    dist = int(ends[best_i]) // _W

    def _traceback(i0):
        ops = []
        i, j = i0, Y
        while j > 0:
            w = sub_w[i - 1] if i > 0 else _W
            if i > 0 and dp[i, j] == dp[i - 1, j - 1] + (
                w if a[i - 1] != r[j - 1] else 0
            ):
                ops.append(M if a[i - 1] == r[j - 1] else S)
                i -= 1
                j -= 1
            elif i > 0 and dp[i, j] == dp[i - 1, j] + w:
                ops.append(D)
                i -= 1
            elif dp[i, j] == dp[i, j - 1] + ins_w[i]:
                ops.append(I)
                j -= 1
            else:  # pragma: no cover - fallback
                ops.append(S)
                i = max(0, i - 1)
                j -= 1
        ops.reverse()
        return i, ops

    start, ops = _traceback(best_i)
    if not with_last:
        return dist, start, ops
    eq = np.nonzero(ends == ends[best_i])[0]
    last_i = int(eq.max())
    last_start = start if last_i == best_i else _traceback(last_i)[0]
    return dist, start, ops, last_start


def calc_hit(
    emission,
    read: np.ndarray,
    props,
    read_error_rate: float,
    is_patched: bool = False,
) -> EditHit | None:
    """EditDistanceCalculation::calc_best_hit (edit_distance.rs:164-358)."""
    allele = emission.seq
    if len(allele) == 0 or len(read) == 0:
        return None
    dist, start, ops, last_start = semiglobal_edit(allele, read, with_last=True)
    second = None
    if last_start != start:
        second = semiglobal_edit(allele[last_start:], read)
        if second is not None:
            second = second[:3]
    return finish_hit(
        emission, read, props, read_error_rate,
        dist, start, ops, last_start, second, is_patched,
    )


def finish_hit(
    emission,
    read: np.ndarray,
    props,
    read_error_rate: float,
    dist: int,
    start: int,
    ops: list,
    last_start: int,
    second,  # (dist2, start2_rel, ops2) alignment at last_start, or None
    is_patched: bool = False,
) -> EditHit:
    """Post-process raw alignment parts into an EditHit (the part of
    calc_best_hit after the DP: hit window, co-optimal edit-op counts,
    explainability, homopolymer op). Split out so the DP parts can come
    from the batched native path (io/native.py hybrid_hits_batch)."""
    allele = emission.seq
    # the hit window spans from the FIRST co-optimal placement's start to
    # the LAST one's putative end, so the banded HMM sums the probability
    # mass of every co-optimal placement (edit_distance.rs:225-240) — in
    # repeat contexts this is several placements, not one
    end = min(last_start + len(read) + dist, len(allele))
    hit = EditHit(dist=dist, start=start, end=end, ops=ops)

    # co-optimal placements considered for edit-operation counts and the
    # homopolymer op: the reference evaluates ALL of them and takes the
    # min (edit_distance.rs:246-301); we evaluate the first and last —
    # middle placements of >2-way repeat ties are not enumerated
    placements = [(start, ops)]
    if last_start != start:
        if second is not None and second[0] == dist:
            placements.append((last_start + second[1], second[2]))

    vrange = getattr(emission, "variant_ref_range", None)
    if not is_patched and vrange is not None:
        lo, hi = vrange
        best = None
        for p_start, p_ops in placements:
            pos = emission.ref_offset + p_start
            n_s = n_i = n_d = 0
            aln_start = pos
            for op in p_ops:
                in_range = lo <= pos < hi
                if op == S:
                    if in_range:
                        n_s += 1
                    pos += 1
                elif op == D:
                    if in_range:
                        n_d += 1
                    pos += 1
                elif op == I:
                    if in_range:
                        n_i += 1
                else:
                    pos += 1
            aln_len = pos - aln_start
            expl = is_explainable_by_error_rates(
                n_s, n_i, n_d, aln_len, props, read_error_rate
            )
            # reference Ord: explainable < not, then subs, ins, dels
            key = (not expl, n_s, n_i, n_d)
            if best is None or key < best[0]:
                best = (key, n_s, n_i, n_d, expl, p_start, p_ops)
        _, n_s, n_i, n_d, expl, w_start, w_ops = best
        hit.n_subst_in_range = n_s
        hit.n_ins_in_range = n_i
        hit.n_del_in_range = n_d
        hit.explainable = expl
        hit.range_start = w_start
        hit.range_ops = w_ops

    # homopolymer indel length (edit_distance.rs:239-...; homopolymers.rs):
    # min indel length over the co-optimal placements
    hrange = getattr(emission, "homopolymer_ref_range", None)
    if not is_patched and hrange is not None:
        lo, hi = hrange
        lens = []
        for p_start, p_ops in placements:
            op_res = homopolymer_indel_operation(
                np.frombuffer(bytes(allele), dtype=np.uint8)[p_start:],
                read,
                p_ops,
            )
            if op_res is not None:
                oplen, text_pos = op_res
                ref_pos = emission.ref_offset + p_start + text_pos
                if lo <= ref_pos < hi and (
                    oplen > 0 or lo <= ref_pos + abs(oplen) < hi
                ):
                    lens.append(oplen)
        if lens:
            hit.homopolymer_indel_len = min(lens)
    return hit


def is_explainable_by_error_rates(
    n_subs, n_ins, n_del, alignment_len, props, read_error_rate
):
    """edit_distance.rs:31-47."""
    expected = lambda lp: alignment_len * math.exp(lp)  # noqa: E731
    return (
        n_subs <= expected(read_error_rate)
        and n_ins <= expected(props.gap_params.prob_insertion_artifact)
        and n_del <= expected(props.gap_params.prob_deletion_artifact)
    )


def derive_patched_allele(emission, read: np.ndarray, hit: EditHit) -> bytes | None:
    """edit_distance.rs:360-467: patch the allele with the read's edits that
    fall inside the variant ref range."""
    if hit.explainable is None or hit.explainable:
        return None
    # patch from the alignment whose edit-operation counts won the
    # co-optimal comparison (edit_distance.rs some_alignment)
    p_start = hit.range_start if hit.range_start is not None else hit.start
    p_ops = hit.range_ops if hit.range_ops is not None else hit.ops
    allele = np.frombuffer(bytes(emission.seq), dtype=np.uint8)
    lo, hi = emission.variant_ref_range
    read_b = np.asarray(read, dtype=np.uint8)
    if len(p_ops) < 48:
        # short op walks: the scalar loop beats numpy's fixed call costs
        pos_ref = p_start
        pos_read = 0
        out = bytearray(bytes(allele[:p_start]))
        for op in p_ops:
            in_r = lo <= (pos_ref + emission.ref_offset) < hi
            if op == M:
                out.append(allele[pos_ref]); pos_ref += 1; pos_read += 1
            elif op == S:
                out.append(read_b[pos_read] if in_r else allele[pos_ref])
                pos_ref += 1; pos_read += 1
            elif op == D:
                # reference parity (edit_distance.rs:416-424): deletions
                # drop the allele base regardless of the variant range
                if not _PARITY_DEL and not in_r:
                    out.append(allele[pos_ref])
                pos_ref += 1
            elif op == I:
                if in_r:
                    out.append(read_b[pos_read])
                pos_read += 1
        del_len = abs(min(emission.alt_vs_ref_len_diff, 0))
        tail_end = max(len(allele) - del_len, pos_ref)
        out.extend(bytes(allele[pos_ref:tail_end]))
        return bytes(out)
    # vectorized op walk for long alignments: per-op ref/read cursors are
    # exclusive prefix sums of the consume masks; emit source/selection
    # follows the same M/S/D/I rules incl. the Del-op parity quirk.
    ops_a = np.asarray(p_ops, dtype=np.int64)
    is_m = ops_a == M
    is_s = ops_a == S
    is_d = ops_a == D
    is_i = ops_a == I
    ref_c = is_m | is_s | is_d
    read_c = is_m | is_s | is_i
    pos_ref = p_start + np.cumsum(ref_c) - ref_c
    pos_read = np.cumsum(read_c) - read_c
    in_range = (pos_ref + emission.ref_offset >= lo) & (
        pos_ref + emission.ref_offset < hi
    )
    from_read = (is_s | is_i) & in_range
    emit = is_m | is_s | (is_i & in_range)
    if _PARITY_DEL:
        pass  # all read deletions drop the allele base
    else:
        emit = emit | (is_d & ~in_range)
        from_read = from_read & ~is_d
    vals = np.where(
        from_read,
        read_b[np.minimum(pos_read, len(read_b) - 1)],
        allele[np.minimum(pos_ref, len(allele) - 1)],
    )
    pos_ref_end = int(p_start + ref_c.sum())
    del_len = abs(min(emission.alt_vs_ref_len_diff, 0))
    tail_end = max(len(allele) - del_len, pos_ref_end)
    return (
        allele[:p_start].tobytes()
        + vals[emit].astype(np.uint8).tobytes()
        + allele[pos_ref_end:tail_end].tobytes()
    )


# ---------------------------------------------------------------------------
# homopolymer indel op (homopolymers.rs:53-160)
# ---------------------------------------------------------------------------


def _is_homopolymer(seq) -> bool:
    return len(seq) > 0 and len(set(bytes(seq))) == 1


def _extend_stretch(base, it) -> int:
    n = 0
    for c in it:
        if c == base:
            n += 1
        else:
            break
    return n


def homopolymer_indel_operation(text: np.ndarray, pattern: np.ndarray, ops):
    """Returns (indel_len, text_pos) if exactly one homopolymer indel,
    else None. text = allele from alignment start, pattern = read."""
    text = np.asarray(text, dtype=np.uint8)
    pattern = np.asarray(pattern, dtype=np.uint8)
    rpos = qpos = 0
    found = None
    text_pos = 0

    def is_extendable(rpos, base):
        if len(text) == 0:
            return False
        min_len = 0 if rpos < len(text) - 1 and text[rpos] == base else 1
        fwd = (
            rpos < len(text) - 1
            and _extend_stretch(base, text[rpos + 1 :]) > min_len
        )
        bwd = rpos > 0 and _extend_stretch(base, text[:rpos][::-1]) > min_len
        return fwd or bwd

    # group consecutive identical ops
    groups = []
    for op in ops:
        if groups and groups[-1][0] == op:
            groups[-1][1] += 1
        else:
            groups.append([op, 1])
    for op, length in groups:
        if op in (M, S):
            qpos += length
            rpos += length
        elif op == D:
            seg = text[rpos : rpos + length]
            if length < 256 and _is_homopolymer(seg) and is_extendable(rpos, seg[0]):
                if found is None:
                    found = -length
                    text_pos = rpos
                else:
                    return None
            rpos += length
        elif op == I:
            seg = pattern[qpos : qpos + length]
            # no rpos < len(text) gate: an insertion aligned at the end of
            # the allele window is still homopolymer-extendable via the
            # backward stretch (homopolymers.rs Ins arm has no such gate)
            if (
                length <= 256
                and _is_homopolymer(seg)
                and is_extendable(rpos, seg[0])
            ):
                if found is None:
                    found = length
                    text_pos = rpos
                else:
                    return None
            qpos += length
    if found is None:
        return None
    return found, text_pos
