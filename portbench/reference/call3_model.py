"""The plain reference of the three-sample call: event posteriors and MAP
allele frequencies of a scenario whose samples are one uncontaminated
sample (the normal) and the samples it contaminates (a tumor and its
relapse), with events that may hold an l2fc predicate between two of the
contaminated samples, computed locus by locus from the read observations
that the generator drew (``portbench/lib/calls_input3.py``).

It shares no code with the program and reads none of its files.  It is the
model of ``call_model`` (its steps 1 to 7, which name the upstream rules)
with three samples, and takes from it what does not depend on their
number: spectra, observable-bound weights, the artifact combinations and
their gate, the read sums, the MAP refinement.  What is new here:

1. Events.  An atom is ``sample:spectrum`` or ``l2fc(a, b) cmp x``
   (upstream's grammar, ``src/grammar/formula.pest``).  The l2fc predicate
   (upstream's ``src/utils/log2_fold_change.rs``) holds at a pair of grid
   points (v_a, v_b) where log2(v_a / v_b) compares so with x, the log
   being +inf where only v_b is 0, -inf where only v_a is 0, and 0 where
   both are.  The constraints of a branch on one pair hold together.
2. Grid.  ``call_model``'s rule, sample by sample.
3. Reads.  A read of a contaminated sample shows the alternative allele
   with weight (1 - f) v + f v_n, f the contamination fraction, v the
   sample's own frequency and v_n the normal's (frequency 1 bypassing
   ``prob_sample_alt`` by the same shares).  The normal's reads see v_n.
4. Posteriors.  A branch's value at an artifact combination is the
   integral over the joint (normal, tumor, relapse) grid of the weights,
   the likelihoods and the l2fc predicate.  Given the normal's point, the
   contaminated samples are independent but for the predicate, so the
   integral is taken as a sum over the normal's grid of the normal's term
   times, for each contaminated sample outside a predicate, its own sum,
   and for the constrained pair the bilinear form of its two exponentiated
   terms through the predicate's 0/1 matrix (float64, each term shifted by
   its largest value).
5. Allele frequencies.  For the most probable event that is no artifact,
   a sample's density over its grid at the combination without artifacts,
   within the event's support, the other samples summed out; the l2fc
   predicate does not enter it (the program's densities are those of
   upstream's ``calling.rs`` over the support alone).

``lower=True`` computes the per-read terms in bfloat16 (the control).
"""

from __future__ import annotations

import itertools
import math
import re

import numpy as np

from .call_model import (
    COMBOS,
    HALF,
    LN_32,
    Spectrum,
    _factors,
    _ln1mexp,
    _lse,
    _map_af,
    _read_sums,
    artifact_gate,
    reads_of,
    weights,
)

L2FC = re.compile(r"l2fc\(\s*(\w+)\s*,\s*(\w+)\s*\)\s*(<=|>=|<|>)\s*(\S+)")
COMPARE = {"<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}


def log2_fold_change(a, b):
    """log2(a / b) of allele frequencies, elementwise (float64): +inf where
    only b is 0, -inf where only a is 0, 0 where both are."""
    a, b = np.broadcast_arrays(np.asarray(a, np.float64), np.asarray(b, np.float64))
    out = np.zeros(a.shape)
    both = (a > 0) & (b > 0)
    out[both] = np.log2(a[both] / b[both])
    out[(a > 0) & (b == 0)] = np.inf
    out[(a == 0) & (b > 0)] = -np.inf
    return out


def l2fc_holds(op, x, a, b):
    """Where ``l2fc(a, b) op x`` holds, for frequencies ``a`` and ``b``."""
    return COMPARE[op](log2_fold_change(a, b), x)


class Scenario:
    """Samples, universes, contamination, event branches and l2fc
    constraints of the configuration's ``scenario``."""

    def __init__(self, scenario, resolution):
        spec = scenario["samples"]
        self.names = list(spec)
        n = len(self.names)
        self.resolution = resolution
        self.universe = [[Spectrum.parse(p) for p in spec[s]["universe"].split("|")]
                         for s in self.names]
        self.sample_res = [spec[s].get("resolution") for s in self.names]
        self.parent, self.fraction = [None] * n, [0.0] * n
        for i, s in enumerate(self.names):
            c = spec[s].get("contamination")
            if c:
                self.parent[i] = self.names.index(c["by"])
                self.fraction[i] = float(c["fraction"])
        roots = [i for i in range(n) if self.parent[i] is None]
        if len(roots) != 1 or any(self.parent[i] not in (None, roots[0]) for i in range(n)):
            raise NotImplementedError("the reference integrates one uncontaminated sample "
                                      "and the samples it contaminates")
        self.root = roots[0]
        self.children = [i for i in range(n) if i != self.root]
        formulas = {"absent": " & ".join(f"{s}:0.0" for s in self.names)}
        formulas.update(scenario["events"])
        self.events = list(formulas)
        self.branches = {e: self._branches(f) for e, f in formulas.items()}
        self._grid()

    def _branches(self, formula):
        """[(spectra, l2fc constraints)]: a spectrum per sample, one branch
        per part of the universe of each sample the formula leaves out;
        constraints (a, b, op, x)."""
        atoms, lfc = {}, []
        for atom in formula.split("&"):
            m = L2FC.fullmatch(atom.strip())
            if m:
                a, b = self.names.index(m[1]), self.names.index(m[2])
                if self.root in (a, b):
                    raise NotImplementedError("l2fc against the uncontaminated sample")
                lfc.append((a, b, m[3], float(m[4])))
                continue
            name, text = atom.split(":", 1)
            si = self.names.index(name.strip())
            sp = Spectrum.parse(text)
            for p in sp.points():
                if not any(u.contains(p) or (u.is_range and p in (u.start, u.end))
                           for u in self.universe[si]):
                    raise NotImplementedError(f"{formula}: outside the universe")
            atoms[si] = sp
        if len({(a, b) if a < b else (b, a) for a, b, _, _ in lfc}) > 1:
            raise NotImplementedError("l2fc constraints on more than one pair")
        parts = [[atoms[si]] if si in atoms else self.universe[si]
                 for si in range(len(self.names))]
        return [(tuple(b), tuple(lfc)) for b in itertools.product(*parts)]

    def _grid(self):
        """``call_model.Scenario._grid`` for any number of samples."""
        res = self.resolution
        n = int(round(1.0 / res)) + 1
        spectra = [b for bs in self.branches.values() for b, _ in bs]
        extra = [p for b in spectra for sp in b for p in sp.points()]
        pts = np.unique(np.round(np.concatenate([np.linspace(0.0, 1.0, n), extra]), 10))
        grid = pts[(pts >= 0) & (pts <= 1)].astype(np.float32)
        g64 = np.round(grid.astype(np.float64), 10)
        self.values = []
        for si in range(len(self.names)):
            r = self.sample_res[si]
            if r is None or r <= res * (1 + 1e-9):
                idx = np.arange(len(grid))
            else:
                want = {0.0, 1.0}
                k = 0
                while k * r <= 1.0 + r * 0.5:
                    want.add(round(min(k * r, 1.0), 10))
                    k += 1
                for b in spectra:
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
                                for v in self.values[si]]) for si in range(len(self.names))]

    def mask(self, lfc):
        """(a, b, [Ga, Gb] bool) of a branch's l2fc constraints, or None."""
        if not lfc:
            return None
        a, b = lfc[0][0], lfc[0][1]
        va = self.values[a].astype(np.float64)[:, None]
        vb = self.values[b].astype(np.float64)[None, :]
        m = np.ones((len(self.values[a]), len(self.values[b])), bool)
        for x, y, op, value in lfc:
            m &= l2fc_holds(op, value, va, vb) if (x, y) == (a, b) \
                else l2fc_holds(op, value, vb, va)
        return a, b, m


def _sample_sums(sc, si, r, combos, fwd_rate, lower):
    """[C, G] read sums of the normal's reads, [C, G, G_normal] of a
    contaminated sample's (its own frequency, the normal's)."""
    terms = [_factors(COMBOS[ci], r, fwd_rate) for ci in combos]
    own = sc.values[si].astype(np.float64)
    if si == sc.root:
        nu, kappa = own, (own == 1).astype(np.float64)
    else:
        other = sc.values[sc.root].astype(np.float64)
        f = sc.fraction[si]
        nu = ((1 - f) * own[:, None] + f * other[None, :]).ravel()
        kappa = ((1 - f) * (own == 1)[:, None] + f * (other == 1)[None, :]).ravel()
    if not len(r["pa"]):
        s = np.zeros((len(combos), len(nu)))
    else:
        A = np.stack([r["pm"] + t[0] + r["pa"] for t in terms])
        R = np.stack([r["pm"] + t[1] + r["pr"] for t in terms])
        M = np.stack([_ln1mexp(r["pm"]) + r["pme"] + t[2] for t in terms])
        psa = np.exp(np.minimum(r["psa"], 0.0))[:, None]
        w = np.clip(psa * nu[None] + kappa[None] * (1 - psa), 0.0, 1.0)
        s = _read_sums(A, R, M, w, lower)
    return s if si == sc.root else s.reshape(len(combos), len(own), -1)


def _shift_exp(x, axis):
    """(exp(x - m), m) with m the largest of ``x`` along ``axis`` (0 where
    that is not finite)."""
    m = np.max(x, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    return np.exp(x - m), np.squeeze(m, axis)


def _branch_value(sc, ll, w, lfc):
    """[C] log integral of one branch: ``ll`` the read sums by sample, ``w``
    the branch's log weights by sample."""
    root = ll[sc.root] + w[sc.root][None, :]  # [C, Gn]
    pair = sc.mask(lfc)
    inner = [c for c in sc.children if pair is None or c not in pair[:2]]
    for c in inner:
        root = root + _lse(ll[c] + w[c][None, :, None], axis=1)
    if pair is not None:
        a, b, m = pair
        ea, ma = _shift_exp(ll[a] + w[a][None, :, None], 1)  # [C, Ga, Gn], [C, Gn]
        eb, mb = _shift_exp(ll[b] + w[b][None, :, None], 1)
        form = np.einsum("cap,ab,cbp->cp", ea, m.astype(np.float64), eb, optimize=True)
        with np.errstate(divide="ignore"):
            root = root + np.log(form) + ma + mb
    return _lse(root, axis=1)


def _densities(sc, ll, support):
    """Per sample, the [G] log density at the combination without
    artifacts within one branch's support (0 / -inf per point)."""
    g_root = ll[sc.root][0] + support[sc.root]  # [Gn]
    h = {c: ll[c][0] + support[c][:, None] for c in sc.children}  # [Gc, Gn]
    hs = {c: _lse(h[c], axis=0) for c in sc.children}  # [Gn]
    dens = [None] * len(sc.names)
    dens[sc.root] = g_root + sum(hs.values())
    for c in sc.children:
        rest = g_root + sum(hs[o] for o in sc.children if o != c)
        dens[c] = _lse(h[c] + rest[None, :], axis=1)
    return dens


def call_locus(sc, reads, allowed, lower=False):
    """({event: log posterior, "artifact": ...}, [MAP frequency per
    sample]) at one locus; ``reads`` holds one dict of read columns per
    sample (float64 values of the drawn float16 columns)."""
    n_s = len(sc.names)
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
    ll = [_sample_sums(sc, si, r, combos, fwd_rate, lower) for si, r in enumerate(adj)]
    n = [len(r["pa"]) for r in adj]
    clear = [n[si] > 10 and bool(((adj[si]["pr"] - adj[si]["pa"]) > LN_32).all())
             for si in range(n_s)]
    valid = [np.where(sc.valid[si], 0.0, -np.inf) for si in range(n_s)]

    def branch_w(spectra, si):
        if clear[si] and spectra[si].excludes_zero():
            return np.full(len(sc.values[si]), -np.inf)
        return weights(spectra[si], sc.values[si], n[si]) + valid[si]

    value = {e: np.stack([_branch_value(sc, ll, [branch_w(b, si) for si in range(n_s)], lfc)
                          for b, lfc in sc.branches[e]])  # [B, C]
             for e in sc.events}
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
        return post, [0.0] * n_s
    best_ev = max(sc.events, key=lambda k: (vals[k], -sc.events.index(k)))
    dens = [[] for _ in range(n_s)]
    for b, _ in sc.branches[best_ev]:
        support = [np.where(np.isfinite(branch_w(b, si)), 0.0, -np.inf) for si in range(n_s)]
        for si, d in enumerate(_densities(sc, ll, support)):
            dens[si].append(d)
    afs = [_map_af(_lse(np.stack(dens[si]), axis=0), sc.values[si].astype(np.float64))
           for si in range(n_s)]
    return post, afs


def calls(inputs, config, lower=False):
    """{(VCF position, ref, alt): ({event: probability}, {sample: AF})} of
    every locus of ``inputs``."""
    sc = Scenario(config["scenario"], config["resolution"])
    if list(inputs["samples"]) != sc.names:
        raise ValueError("the inputs' samples are not the scenario's, in its order")
    # an SNV allows every artifact but the homopolymer one
    allowed = [True, True, True, True, True, True, True, False, True]
    out = {}
    for i, reads in enumerate(reads_of(inputs)):
        got = call_locus(sc, reads, allowed, lower)
        key = (int(inputs["pos"][i]) + 1, str(inputs["ref"][i]), str(inputs["alt"][i]))
        if got is None:
            out[key] = ({}, {name: math.nan for name in sc.names})
            continue
        post, afs = got
        out[key] = ({e: math.exp(v) for e, v in post.items()}, dict(zip(sc.names, afs)))
    return out
