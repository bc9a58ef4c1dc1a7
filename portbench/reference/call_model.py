"""The plain reference of the call: event posteriors and MAP allele
frequencies of a two-sample scenario, computed locus by locus from the read
observations that the generator drew (``portbench/lib/calls_input.py``).

It shares no code with the program and reads none of its files.  It states
the model that the program serves (varlociraptor's, as the program
documents it) in numpy, in float64, and in the order in which a reader
would check it:

1. Events.  The scenario's formulas are conjunctions of ``sample:spectrum``
   atoms; a sample that an event leaves out takes each part of its universe
   (one branch per part).  ``absent`` puts every sample at 0.  Each event
   but ``absent`` has an artifact twin with the same branches.
2. Grid.  Allele frequencies are integrated on a grid: 0 to 1 in steps of
   the call's resolution, with every value and end point the events name.
   A sample with a coarser ``resolution`` of its own keeps only its own
   lattice, the named values, and points a third and two thirds of its step
   inside each end of a range, each moved to the nearest point of the grid.
   A point outside a sample's universe has no mass.
3. Weights.  A set spectrum weighs its members 1.  A range weighs the grid
   points between its least and greatest observable frequency (a frequency
   that ``n`` reads can show, n the sample's depth) by the trapezoid rule;
   below 10 reads the range is taken as written.  Where a sample has more
   than 10 reads and each favours the reference by a Bayes factor over 3.2,
   branches that rule out 0 for it get no mass.
4. Reads.  A read maps with ``prob_mapping`` and then shows the alternative
   allele with weight w, the reference with 1 - w; unmapped, it shows the
   allele it missed.  w is the allele frequency that the read samples
   (a contaminated sample mixes its own frequency with its contaminant's by
   the contamination fraction), except that frequency 1 bypasses
   ``prob_sample_alt``.  A locus whose only alternative-supporting read is
   one read has that read's evidence set to 1/2 each way.
5. Artifacts.  Each of the eight artifact combinations (strand +/-, pair
   orientation F1R2/F2R1, read position, soft clip, homopolymer, alternative
   locus) multiplies each read's terms by its factors.  A combination is
   tried at a locus where the variant's kind allows it and the reads make it
   possible, informative and likely; the artifact twins share a prior of
   1/2 over the combinations that the kind allows, the other events 1/2.
   The program's documentation of each rule names the upstream source line.
6. Posteriors.  An event's value is the sum over its branches of the
   integral over the joint grid of the weights and the likelihoods; the
   posteriors normalise the values of all events.  ``PROB_ARTIFACT`` sums
   the twins.
7. Allele frequencies.  For the most probable event that is no artifact, a
   sample's density over its grid (unweighted, within the event's support,
   the other sample summed out); its arg-max, moved to the vertex of the
   parabola through it and its neighbours.  A call whose most probable
   event is the artifact reports 0.

``lower=True`` computes step 4's per-read terms in bfloat16 (the control).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np

HALF = math.log(0.5)
LN_32 = math.log(3.2)
STRONG = 10.0  # a Bayes factor above this is strong evidence
UNIQUE = math.log(0.95)  # a read maps uniquely at or above this probability
STRAND_NONE, STRAND_FORWARD, STRAND_REVERSE, STRAND_BOTH = 0, 1, 2, 3
ORIENT_F1R2, ORIENT_F2R1 = 1, 2


# ---------------------------------------------------------------------------
# scenario


@dataclass(frozen=True)
class Spectrum:
    values: tuple = ()  # a set of frequencies, or
    start: float = 0.0  # a range
    end: float = 0.0
    left_open: bool = False
    right_open: bool = False
    is_range: bool = False

    @classmethod
    def parse(cls, text):
        t = text.strip()
        if t[0] in "[]":
            a, b = t[1:-1].split(",")
            return cls(start=float(a), end=float(b), left_open=t[0] == "]",
                       right_open=t[-1] == "[", is_range=True)
        return cls(values=(float(t),))

    def contains(self, v):
        if not self.is_range:
            return v in self.values
        lo = v > self.start if self.left_open else v >= self.start
        hi = v < self.end if self.right_open else v <= self.end
        return lo and hi

    def excludes_zero(self):
        return self.start > 0 if self.is_range else all(v > 0 for v in self.values)

    def points(self):
        return (self.start, self.end) if self.is_range else self.values


class Scenario:
    """Samples, universes, contamination and event branches of the
    configuration's ``scenario``."""

    def __init__(self, scenario, resolution):
        self.names = list(scenario["samples"])
        if len(self.names) != 2:
            raise NotImplementedError("the reference integrates two samples")
        self.resolution = resolution
        spec = scenario["samples"]
        self.universe = [[Spectrum.parse(p) for p in spec[n]["universe"].split("|")]
                         for n in self.names]
        self.sample_res = [spec[n].get("resolution") for n in self.names]
        self.parent = [None, None]
        self.fraction = [0.0, 0.0]
        for i, n in enumerate(self.names):
            c = spec[n].get("contamination")
            if c:
                self.parent[i] = self.names.index(c["by"])
                self.fraction[i] = float(c["fraction"])
        if self.parent[0] is not None and self.parent[1] is not None:
            raise NotImplementedError("mutual contamination")
        formulas = {"absent": " & ".join(f"{n}:0.0" for n in self.names)}
        formulas.update(scenario["events"])
        self.events = list(formulas)
        self.branches = {e: self._branches(f) for e, f in formulas.items()}
        self._grid()

    def _branches(self, formula):
        atoms = {}
        for atom in formula.split("&"):
            name, spec = atom.split(":", 1)
            sp = Spectrum.parse(spec)
            si = self.names.index(name.strip())
            for p in sp.points():
                if not any(u.contains(p) or (u.is_range and p in (u.start, u.end))
                           for u in self.universe[si]):
                    raise NotImplementedError(f"{formula}: outside the universe")
            atoms[si] = sp
        parts = [[atoms[si]] if si in atoms else self.universe[si] for si in range(2)]
        return [tuple(b) for b in itertools.product(*parts)]

    def _grid(self):
        res = self.resolution
        n = int(round(1.0 / res)) + 1
        extra = [p for bs in self.branches.values() for b in bs for sp in b
                 for p in sp.points()]
        pts = np.unique(np.round(np.concatenate([np.linspace(0.0, 1.0, n), extra]), 10))
        grid = pts[(pts >= 0) & (pts <= 1)].astype(np.float32)
        g64 = np.round(grid.astype(np.float64), 10)
        self.values = []
        for si in range(2):
            r = self.sample_res[si]
            if r is None or r <= res * (1 + 1e-9):
                idx = np.arange(len(grid))
            else:
                want = {0.0, 1.0}
                k = 0
                while k * r <= 1.0 + r * 0.5:
                    want.add(round(min(k * r, 1.0), 10))
                    k += 1
                for bs in self.branches.values():
                    for b in bs:
                        sp = b[si]
                        want.update(round(float(p), 10) for p in sp.points())
                        if sp.is_range:
                            for f in (1 / 3, 2 / 3):
                                for p in (sp.start + f * r, sp.end - f * r):
                                    if sp.start < p < sp.end:
                                        want.add(p)
                idx = np.unique([int(np.argmin(np.abs(g64 - v))) for v in want])
            self.values.append(grid[idx])
        self.valid = [np.array([v == 0 or any(u.contains(float(v)) for u in self.universe[si])
                                for v in self.values[si]]) for si in range(2)]


# ---------------------------------------------------------------------------
# weights


def _observable(sp, n):
    """(least, greatest) observable frequency of a range at ``n`` reads, in
    float32 as the grid is."""
    f = np.float32
    n, start, end = f(n), f(sp.start), f(sp.end)
    nn = max(n, f(1.0))
    if n < 10 or not (end - start) * n > 1:
        return start, end
    c = n * end
    if sp.right_open and abs(c - np.round(c)) < 1e-9:
        c = c - f(1)
    c = np.floor(c + f(1e-9))
    hi = end if c == 0 else c / nn
    c = n * start
    if sp.left_open and abs(c - np.round(c)) < 1e-9:
        up = (c + f(1)) / nn
        lo = up if (up <= 1 and up <= hi) else c / nn
    else:
        lo = np.ceil(c - f(1e-9)) / nn
    if lo >= hi:
        lo = start
    return lo, hi


def weights(sp, vals, n):
    """log weights of spectrum ``sp`` on grid ``vals`` at ``n`` reads."""
    if not sp.is_range:
        w = np.full(len(vals), -np.inf)
        for v in sp.values:
            w[int(np.argmin(np.abs(vals.astype(np.float64) - v)))] = 0.0
        return w
    lo, hi = _observable(sp, n)
    inside = (vals >= lo - np.float32(1e-9)) & (vals <= hi + np.float32(1e-9))
    idx = np.nonzero(inside)[0]
    w = np.full(len(vals), -np.inf)
    if len(idx) == 1:
        width = max(float(hi - lo), 1e-12)
        w[idx] = math.log(width)
        return w
    for j in idx:
        left = vals[j - 1] if j > 0 and inside[j - 1] else vals[j]
        right = vals[j + 1] if j + 1 < len(vals) and inside[j + 1] else vals[j]
        width = max(float(np.float32(right - left)), 0.0) * 0.5
        if width > 0:
            w[j] = math.log(width)
    return w


# ---------------------------------------------------------------------------
# artifacts


def _ln1mexp(x):
    x = np.minimum(np.asarray(x, dtype=np.float64), 0.0)
    with np.errstate(divide="ignore"):
        return np.where(x > -math.log(2), np.log(-np.expm1(x)), np.log1p(-np.exp(x)))


# combination: (strand, orientation, read position, soft clip, homopolymer,
# alternative locus); 0 = no artifact in that dimension
COMBOS = [(0, 0, 0, 0, 0, 0), (1, 0, 0, 0, 0, 0), (2, 0, 0, 0, 0, 0), (0, 1, 0, 0, 0, 0),
          (0, 2, 0, 0, 0, 0), (0, 0, 1, 0, 0, 0), (0, 0, 0, 1, 0, 0), (0, 0, 0, 0, 1, 0),
          (0, 0, 0, 0, 0, 1)]


def _factors(combo, r, fwd_rate):
    """Per-read log factors (alt, ref, any) of one combination."""
    sb, ro, rp, sc, he, al = combo
    n = len(r["pa"])
    neg = np.full(n, -np.inf)
    strand, orient = r["strand"], r["orientation"]
    if sb == 1:
        alt = np.where((strand == STRAND_FORWARD) | (strand == STRAND_NONE), 0.0, neg)
    elif sb == 2:
        alt = np.where((strand == STRAND_REVERSE) | (strand == STRAND_NONE), 0.0, neg)
    else:
        rate = np.where(strand == STRAND_FORWARD, fwd_rate, 1.0 - fwd_rate)
        with np.errstate(divide="ignore"):
            single = np.log(rate) + _ln1mexp(r["pdo"])
        alt = np.where(strand == STRAND_BOTH, r["pdo"],
                       np.where(strand == STRAND_NONE, 0.0, single))
    ref = np.full(n, HALF)
    anyf = np.full(n, HALF)
    if ro == 0:
        alt = alt + HALF
    else:
        same, other = (ORIENT_F1R2, ORIENT_F2R1) if ro == 1 else (ORIENT_F2R1, ORIENT_F1R2)
        alt = alt + np.where(orient == same, 0.0, np.where(orient == other, -np.inf, HALF))
    ref, anyf = ref + HALF, anyf + HALF
    hit, major = r["phb"], r["read_position_major"]
    not_hit = np.where((hit == 0) | np.isneginf(hit), 0.0, _ln1mexp(hit))
    any_rp = np.where(major, hit, not_hit)
    alt = alt + (np.where(major, 0.0, -np.inf) if rp else any_rp)
    ref, anyf = ref + any_rp, anyf + any_rp
    if sc:
        alt = alt + np.where(r["softclipped"], 0.0, -np.inf)
    if al:
        alt = alt + np.where(r["max_mapq"], -np.inf, 0.0)
        ref = ref + HALF
    else:
        alt, ref = alt + HALF, ref + HALF
    return alt, ref, anyf + HALF


def _strong(r):
    with np.errstate(over="ignore"):
        alt = (r["pa"] != r["pr"]) & (np.exp(r["pa"] - r["pr"]) > STRONG)
        ref = (r["pa"] != r["pr"]) & (np.exp(r["pr"] - r["pa"]) > STRONG)
    return alt, ref


def _seq_sum(x):
    """Sum of ``x`` added one by one in read order, tumor's reads first, as
    the upstream rules accumulate (a rate of exactly 0.4 stays 0.4)."""
    return float(np.cumsum(x)[-1]) if len(x) else 0.0


def artifact_gate(reads, allowed):
    """(active combinations, forward strand rate) at one locus; ``reads``:
    one dict of raw read columns per sample."""
    both = {k: np.concatenate([r[k] for r in reads]) for k in reads[0]}
    s_alt, s_ref = _strong(both)
    pm_lin = np.exp(both["pm"])
    strand, orient = both["strand"], both["orientation"]
    n_all = len(both["pa"])
    # strand: the forward rate of strongly reference-supporting reads
    tot = _seq_sum(pm_lin[s_ref & (strand != STRAND_BOTH)])
    fwd = _seq_sum(pm_lin[s_ref & (strand == STRAND_FORWARD)])
    frac = fwd / tot if tot > 0 else 0.0
    rate = None
    if tot > 2 and tot > 100 and 0 < frac < 1:
        rate = frac
    elif tot > 2 and 0.4 <= frac <= 0.6:
        rate = 0.5
    inform = {0: rate is not None}
    known = (orient == ORIENT_F1R2) | (orient == ORIENT_F2R1)
    st = int((s_ref & known).sum())
    sf = int((s_ref & (orient == ORIENT_F1R2)).sum())
    inform[1] = (n_all > 0 and (~known).sum() < n_all / 2
                 and st > 2 and 0.3 <= sf / st <= 0.7)
    rp = False
    for r in reads:
        a, sr = _strong(r)
        e_all = _seq_sum(np.exp(r["pm"][sr]))
        e_major = _seq_sum(np.exp(r["pm"][sr & r["read_position_major"]]))
        e_rate = _seq_sum(np.exp(r["pm"][sr] + r["phb"][sr]))
        major = e_major / e_all if e_all > 0 else 0.0
        rp |= bool(e_all > 10 and e_major > 0 and abs(major - e_rate) < 0.05)
    inform[2] = rp
    inform[3] = bool(both["softclipped"].any())
    inform[4] = False  # no read carries homopolymer indel information
    n_alt, n_ref = int(s_alt.sum()), int(s_ref.sum())
    nm_alt = int((s_alt & ~both["max_mapq"]).sum())
    nm_ref = int((s_ref & ~both["max_mapq"]).sum())
    inform[5] = (n_alt > 0 and nm_alt > n_alt * 0.1 and n_alt - nm_alt < 10
                 and n_ref > 0 and nm_ref < n_ref * 0.9)
    fwd_rate = np.float32(rate if rate is not None else 0.5)
    active = [True]
    for ci, combo in enumerate(COMBOS[1:], 1):
        if not allowed[ci] or not all(inform[d] for d in range(6) if combo[d]):
            active.append(False)
            continue
        finite = [np.isfinite(_factors(combo, r, fwd_rate)[0]) for r in reads]
        possible = any(f.any() for f in finite)
        likely = False
        for r, f in zip(reads, finite):
            a, _ = _strong(r)
            strong = a & (r["pm"] >= UNIQUE)
            n_strong = int(strong.sum())
            if n_strong >= 10:
                likely |= (strong & f).sum() / n_strong >= 0.66666
            elif len(r["pa"]) and not (r["pr"] > r["pa"]).all():
                likely = True
        active.append(possible and likely)
    return active, fwd_rate


# ---------------------------------------------------------------------------
# likelihood


def _lse(x, axis=None):
    m = np.max(x, axis=axis, keepdims=True)
    ms = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        out = np.log(np.sum(np.exp(x - ms), axis=axis, keepdims=True)) + ms
    out = np.where(np.isfinite(m), out, m)
    return np.squeeze(out, axis=axis) if axis is not None else out.reshape(())


def _read_sums(A, R, M, w, lower):
    """[C, P] sums over reads of log(w e^A + (1 - w) e^R + e^M); A/R/M
    [C, D], w [D, P]."""
    c = np.maximum(np.maximum(A, R), M)
    c = np.where(np.isfinite(c), c, 0.0)
    a, r, m = (np.exp(x - c) for x in (A, R, M))
    if lower:
        import torch

        bf = torch.bfloat16
        ta, tr, tm = (torch.from_numpy(x).to(bf)[:, :, None] for x in (a, r, m))
        tw = torch.from_numpy(w).to(bf)[None]
        t = tw * ta + (1 - tw) * tr + tm
        ll = torch.log(t).float() + torch.from_numpy(c).float()[:, :, None]
        return ll.sum(dim=1).double().numpy()
    with np.errstate(divide="ignore"):
        t = w[None] * a[:, :, None] + (1 - w[None]) * r[:, :, None] + m[:, :, None]
        return (np.log(t) + c[:, :, None]).sum(axis=1)


def call_locus(sc, reads, allowed, lower=False):
    """({event: log posterior, "artifact": ...}, [MAP frequency per
    sample]) at one locus; ``reads`` holds one dict of read columns per
    sample (float64 values of the drawn float16 columns)."""
    if sum(len(r["pa"]) for r in reads) == 0:
        return None
    active, fwd_rate = artifact_gate(reads, allowed)
    # one alternative-supporting read at the locus: its evidence neutralised
    sup = [r["pa"] > r["pr"] for r in reads]
    adj = [dict(r) for r in reads]
    if sum(int(s.sum()) for s in sup) == 1:
        half16 = float(np.float16(HALF))
        for r, s in zip(adj, sup):
            r["pa"] = np.where(s, half16, r["pa"])
            r["pr"] = np.where(s, half16, r["pr"])
    combos = [ci for ci, on in enumerate(active) if on]
    child = 0 if sc.parent[0] is not None else (1 if sc.parent[1] is not None else None)
    ll = []
    for si, r in enumerate(adj):
        terms = [_factors(COMBOS[ci], r, fwd_rate) for ci in combos]
        A = np.stack([r["pm"] + t[0] + r["pa"] for t in terms])
        R = np.stack([r["pm"] + t[1] + r["pr"] for t in terms])
        M = np.stack([_ln1mexp(r["pm"]) + r["pme"] + t[2] for t in terms])
        psa = np.exp(np.minimum(r["psa"], 0.0))[:, None]
        own = sc.values[si].astype(np.float64)
        if si == child:
            other = sc.values[sc.parent[si]].astype(np.float64)
            f = sc.fraction[si]
            nu = ((1 - f) * own[:, None] + f * other[None, :]).ravel()
            kappa = ((1 - f) * (own == 1)[:, None] + f * (other == 1)[None, :]).ravel()
        else:
            nu, kappa = own, (own == 1).astype(np.float64)
        w = np.clip(psa * nu[None] + kappa[None] * (1 - psa), 0.0, 1.0)
        s = _read_sums(A, R, M, w, lower) if len(r["pa"]) else np.zeros((len(combos), len(nu)))
        if si == child:
            s = s.reshape(len(combos), len(own), -1)
            if child == 1:
                s = s.transpose(0, 2, 1)
        else:
            s = s[:, :, None] if si == 0 else s[:, None, :]
        ll.append(s)
    joint_ll = ll[0] + ll[1]  # [C, G0, G1]
    # weights per branch (clear-reference rule applied)
    n = [len(r["pa"]) for r in adj]
    clear = [n[si] > 10 and bool(((adj[si]["pr"] - adj[si]["pa"]) > LN_32).all())
             for si in range(2)]
    valid = [np.where(sc.valid[si], 0.0, -np.inf) for si in range(2)]

    def branch_w(b, si):
        if clear[si] and b[si].excludes_zero():
            return np.full(len(sc.values[si]), -np.inf)
        return weights(b[si], sc.values[si], n[si]) + valid[si]

    value = {}
    for e in sc.events:
        per_branch = []
        for b in sc.branches[e]:
            w0, w1 = branch_w(b, 0), branch_w(b, 1)
            per_branch.append(_lse(joint_ll + w0[None, :, None] + w1[None, None, :],
                                   axis=(1, 2)))  # [C]
        value[e] = np.stack(per_branch)  # [B, C]
    n_art = math.log(max(1, sum(allowed[1:])))
    vals = {e: HALF + _lse(value[e][:, 0]) for e in sc.events}
    twins = [e for e in sc.events if e != "absent"]
    art = {e: (HALF - n_art + _lse(value[e][:, 1:]) if len(combos) > 1 else -np.inf)
           for e in twins}
    marginal = _lse(np.array(list(vals.values()) + list(art.values())))
    post = {e: v - marginal for e, v in vals.items()}
    post["artifact"] = _lse(np.array([v - marginal for v in art.values()]))
    names = list(sc.events) + ["artifact"]
    best = max(names, key=lambda k: (post[k], -names.index(k)))
    if best == "artifact":
        return post, [0.0, 0.0]
    best_ev = max(sc.events, key=lambda k: (vals[k], -sc.events.index(k)))
    dens = [[], []]
    for b in sc.branches[best_ev]:
        m0 = np.where(np.isfinite(branch_w(b, 0)), 0.0, -np.inf)
        m1 = np.where(np.isfinite(branch_w(b, 1)), 0.0, -np.inf)
        d = joint_ll[0] + m0[:, None] + m1[None, :]
        dens[0].append(_lse(d, axis=1))
        dens[1].append(_lse(d, axis=0))
    afs = [_map_af(_lse(np.stack(dens[si]), axis=0), sc.values[si].astype(np.float64))
           for si in range(2)]
    return post, afs


def _map_af(dens, vals):
    """Arg-max of a density on its grid, moved to the vertex of the parabola
    through it and its two neighbours where that lies between them."""
    g = int(np.argmax(dens))
    if len(vals) < 3 or not 1 <= g <= len(vals) - 2:
        return float(vals[g])
    dm, d0, dp = dens[g - 1], dens[g], dens[g + 1]
    if not (np.isfinite(dm) and np.isfinite(dp)):
        return float(vals[g])
    left, right = vals[g] - vals[g - 1], vals[g + 1] - vals[g]
    num = (dm - d0) * right ** 2 - (dp - d0) * left ** 2
    den = (dm - d0) * right + (dp - d0) * left
    if not den < -1e-12:
        return float(vals[g])
    off = 0.5 * num / den
    if abs(off) > max(left, right):
        return float(vals[g])
    return float(min(max(vals[g] + off, vals[g - 1]), vals[g + 1]))


def reads_of(inputs):
    """Per locus, one dict of float64 read columns per sample."""
    names = list(inputs["samples"])
    per = []
    for name in names:
        counts, c = inputs["samples"][name]
        off = np.concatenate([[0], np.cumsum(counts)])
        cols = {"pm": c["prob_mapping"], "pa": c["prob_alt"], "pr": c["prob_ref"],
                "pme": c["prob_missed_allele"], "psa": c["prob_sample_alt"],
                "pdo": c["prob_double_overlap"], "phb": c["prob_hit_base"]}
        cols = {k: v.astype(np.float64) for k, v in cols.items()}
        cols.update(strand=c["strand"], orientation=c["orientation"], max_mapq=c["max_mapq"],
                    read_position_major=c["read_position_major"],
                    softclipped=c["softclipped"])
        per.append([{k: v[off[i]:off[i + 1]] for k, v in cols.items()}
                    for i in range(len(counts))])
    return [list(x) for x in zip(*per)]


def calls(inputs, config, lower=False):
    """{(VCF position, ref, alt): ({event: probability}, {sample: AF})} of
    every locus of ``inputs``."""
    sc = Scenario(config["scenario"], config["resolution"])
    # an SNV allows every artifact but the homopolymer one
    allowed = [True, True, True, True, True, True, True, False, True]
    out = {}
    for i, reads in enumerate(reads_of(inputs)):
        got = call_locus(sc, reads, allowed, lower)
        key = (int(inputs["pos"][i]) + 1, str(inputs["ref"][i]), str(inputs["alt"][i]))
        if got is None:
            out[key] = ({}, {n: math.nan for n in sc.names})
            continue
        post, afs = got
        out[key] = ({e: math.exp(v) for e, v in post.items()}, dict(zip(sc.names, afs)))
    return out
