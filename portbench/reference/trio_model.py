"""The plain reference of the trio call under --full-prior: event posteriors
and MAP allele frequencies of a child and both parents, under the joint
prior of upstream's generic scenario with Mendelian inheritance, computed
locus by locus from the read observations that the generator drew
(``portbench/lib/calls_input_trio.py``).

It shares no code with the program and reads none of its files.  It is the
model of ``call_model`` (its steps 1 to 7) with three uncontaminated
samples, and takes from it what does not depend on their number: spectra,
observable-bound weights, the artifact combinations and their gate, the
read sums, the MAP refinement.  What is new here, in torch float64 on the
CPU:

1. Samples.  In the order of their names, as upstream's scenario map
   orders them.  A sample without a universe of its own has the one its
   ploidy and sample-level somatic rate give (upstream's
   ``grammar/mod.rs:503-579``): the open ranges between consecutive
   multiples of 1 / ploidy and the set of those multiples.
2. Events.  An event is a conjunction of terms; a term is an atom
   ``sample:spectrum`` or a parenthesised disjunction of atoms.  The atoms of
   a disjunction on one sample merge into one set (upstream's atom merge);
   each sample group of a disjunction is one alternative, and a branch takes
   one alternative of each disjunction (upstream's ``vaftree.rs``: a
   disjunction branches, and branches may overlap).  A sample that a branch
   leaves out takes each part of its universe.
3. The joint prior (upstream's ``prior.rs:298-438``, with
   ``is_absent_only`` false, ``--full-prior``).  At allele frequencies
   (v_s) it is the sum over every sample's germline genotype n_s (0 to its
   ploidy alternative alleles) of the product of
   * the population prior of the samples without inheritance
     (``prior.rs:554-582``, Watterson): heterozygosity / m for m > 0
     alternative alleles among them, 1 - sum_k heterozygosity / k (k from 1
     to their ploidy) for m = 0;
   * the Mendelian term of the child (``prior.rs:600-712``): each parent
     passes half its ploidy (both halves where the ploidy is odd), the
     alternative alleles it passes drawn without replacement
     (hypergeometric), and each of the child's alleles beyond those passed
     is a de novo mutation at the germline mutation rate; the child never
     has fewer than it was passed;
   * per sample, the flat somatic mass (``prior.rs:440-456``): 1 - rate
     where v_s is its germline allele frequency n_s / ploidy, rate
     elsewhere.
   Every factor is one sample's or none, so the prior is a sum of products
   of per-sample vectors, one term a genotype combination.
4. Posteriors.  A branch's value at an artifact combination is the sum over
   the joint grid of the samples' weights and likelihoods times the prior:
   with each sample's exponentiated terms shifted by their largest value,
   for each genotype combination the product of three dot products, summed
   over the combinations (exact in float64: no cancellation).
5. Allele frequencies.  As ``call3_model``: for the most probable event
   that is no artifact, a sample's density over its grid at the combination
   without artifacts, within the event's support, the other samples summed
   out; the prior does not enter it (upstream's ``calling.rs`` densities).

``lower=True`` computes the per-read terms in bfloat16 (the control).
"""

from __future__ import annotations

import itertools
import math
import re

import numpy as np
import torch

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

F64 = torch.float64
ATOM = re.compile(r"\s*(\w+)\s*:\s*(\S+)\s*")


def _ploidy_universe(ploidy, somatic):
    """Upstream's universe of a sample without its own: the multiples of
    1 / ploidy, and with a sample-level somatic rate the open ranges between
    them too (ranges first, as upstream lists them)."""
    pts = [k / ploidy for k in range(ploidy + 1)] if ploidy > 0 else [0.0]
    parts = []
    if somatic:
        parts = [Spectrum(start=a, end=b, left_open=True, right_open=True, is_range=True)
                 for a, b in zip(pts[:-1], pts[1:])]
    return parts + [Spectrum(values=tuple(pts))]


def _split_top(text, sep):
    """``text`` split at ``sep`` outside parentheses."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == sep and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def _atom(text):
    m = ATOM.fullmatch(text)
    if not m:
        raise NotImplementedError(f"atom {text!r}")
    return m[1], Spectrum.parse(m[2])


def _union(spectra):
    """One set spectrum of the union of set spectra (the merged atoms of a
    disjunction on one sample)."""
    if any(sp.is_range for sp in spectra):
        raise NotImplementedError("a range inside a disjunction")
    return Spectrum(values=tuple(sorted({v for sp in spectra for v in sp.values})))


class Scenario:
    """Samples, universes, the prior's parameters and the events' branches
    of the configuration's ``scenario``."""

    def __init__(self, scenario, resolution):
        spec = scenario["samples"]
        species = scenario.get("species", {})
        self.names = sorted(spec)
        self.resolution = resolution
        self.ploidy = [int(spec[s]["ploidy"]) for s in self.names]
        self.somatic = [spec[s].get("somatic-effective-mutation-rate") for s in self.names]
        self.heterozygosity = species.get("heterozygosity")
        self.germline_rate = [spec[s].get("germline-mutation-rate",
                                          species.get("germline-mutation-rate"))
                              for s in self.names]
        self.parents = [None] * len(self.names)
        for i, s in enumerate(self.names):
            inh = spec[s].get("inheritance")
            if inh:
                if list(inh) != ["mendelian"]:
                    raise NotImplementedError("inheritance other than mendelian")
                self.parents[i] = tuple(self.names.index(p) for p in inh["mendelian"]["from"])
        self.universe = [
            [Spectrum.parse(p) for p in spec[s]["universe"].split("|")] if "universe" in spec[s]
            else _ploidy_universe(self.ploidy[i], self.somatic[i] is not None)
            for i, s in enumerate(self.names)]
        formulas = {"absent": " & ".join(f"{s}:0.0" for s in self.names)}
        formulas.update(scenario["events"])
        self.events = list(formulas)
        self.branches = {e: self._branches(f) for e, f in formulas.items()}
        self._grid()

    def _branches(self, formula):
        """[spectra per sample] of an event: one branch per choice of an
        alternative in each disjunction and of a universe part for each
        sample left out."""
        fixed, choices = {}, []
        for term in _split_top(formula, "&"):
            term = term.strip()
            if term.startswith("("):
                groups = {}
                for a in _split_top(term[1:-1], "|"):
                    name, sp = _atom(a)
                    groups.setdefault(name, []).append(sp)
                choices.append([{self.names.index(n): _union(sps)} for n, sps in groups.items()])
            else:
                name, sp = _atom(term)
                fixed[self.names.index(name)] = sp
        out = []
        for pick in itertools.product(*choices):
            atoms = dict(fixed)
            for alt in pick:
                if set(alt) & set(atoms):
                    raise NotImplementedError("a sample both in and outside a disjunction")
                atoms.update(alt)
            parts = [[atoms[i]] if i in atoms else self.universe[i]
                     for i in range(len(self.names))]
            out.extend(tuple(b) for b in itertools.product(*parts))
        return out

    def _grid(self):
        """``call_model``'s grid: 0 to 1 in steps of the resolution with
        every point the events name, the same for every sample."""
        n = int(round(1.0 / self.resolution)) + 1
        extra = [p for bs in self.branches.values() for b in bs for sp in b
                 for p in sp.points()]
        pts = np.unique(np.round(np.concatenate([np.linspace(0.0, 1.0, n), extra]), 10))
        grid = pts[(pts >= 0) & (pts <= 1)].astype(np.float32)
        self.values = [grid for _ in self.names]
        self.valid = [np.array([v == 0 or any(u.contains(float(v)) for u in self.universe[si])
                                for v in grid]) for si in range(len(self.names))]


def _hypergeom(total, successes, draws, k):
    """P(k successes in ``draws`` draws without replacement from ``total``
    items of which ``successes`` are successes)."""
    if k < max(0, draws - (total - successes)) or k > min(successes, draws):
        return 0.0
    return math.comb(successes, k) * math.comb(total - successes, draws - k) / math.comb(total, draws)


def _mendel(sc, child, n, rate):
    """The child's Mendelian term at genotypes ``n`` (alternative alleles
    per sample)."""
    p0, p1 = sc.parents[child]
    pl0, pl1 = sc.ploidy[p0], sc.ploidy[p1]

    def halves(p):
        return [p // 2] if p % 2 == 0 else [p // 2, p // 2 + 1]

    total = 0.0
    splits = [(h0, h1) for h0 in halves(pl0) for h1 in halves(pl1)
              if h0 + h1 == sc.ploidy[child]]
    if not splits:
        raise ValueError("the child's ploidy is not its parents' halves")
    for h0, h1 in splits:
        for a0 in range(min(n[p0], h0) + 1):
            for a1 in range(min(n[p1], h1) + 1):
                if a0 + a1 <= n[child]:
                    total += (_hypergeom(pl0, n[p0], h0, a0) * _hypergeom(pl1, n[p1], h1, a1)
                              * rate ** (n[child] - a0 - a1))
    return total


def prior_factors(sc):
    """(c [O], [F_s [O, G_s]]): the joint prior as a sum over the O genotype
    combinations of c_o times the product of the per-sample vectors F_s[o]
    (torch float64)."""
    S = len(sc.names)
    pop = [s for s in range(S) if sc.parents[s] is None]
    n_pop = sum(sc.ploidy[s] for s in pop)
    het = sc.heterozygosity
    combos = list(itertools.product(*(range(sc.ploidy[s] + 1) for s in range(S))))
    c = []
    for n in combos:
        m = sum(n[s] for s in pop)
        w = het / m if m > 0 else 1.0 - sum(het / k for k in range(1, n_pop + 1))
        for s in range(S):
            if sc.parents[s] is not None:
                w *= _mendel(sc, s, n, sc.germline_rate[s])
        c.append(w)
    F = []
    for s in range(S):
        v = torch.as_tensor(sc.values[s].astype(np.float64), dtype=F64)
        r = sc.somatic[s]
        rows = []
        for n in combos:
            at = (v - n[s] / sc.ploidy[s]).abs() < 1e-9
            rows.append(torch.where(at, torch.full_like(v, 1.0 - r), torch.full_like(v, r))
                        if r is not None else at.to(F64))
        F.append(torch.stack(rows))
    return torch.as_tensor(c, dtype=F64), F


def _sample_sums(sc, si, r, combos, fwd_rate, lower):
    """[C, G] read sums of one sample's reads (its own frequency)."""
    terms = [_factors(COMBOS[ci], r, fwd_rate) for ci in combos]
    nu = sc.values[si].astype(np.float64)
    kappa = (nu == 1).astype(np.float64)
    if not len(r["pa"]):
        return np.zeros((len(combos), len(nu)))
    A = np.stack([r["pm"] + t[0] + r["pa"] for t in terms])
    R = np.stack([r["pm"] + t[1] + r["pr"] for t in terms])
    M = np.stack([_ln1mexp(r["pm"]) + r["pme"] + t[2] for t in terms])
    psa = np.exp(np.minimum(r["psa"], 0.0))[:, None]
    w = np.clip(psa * nu[None] + kappa[None] * (1 - psa), 0.0, 1.0)
    return _read_sums(A, R, M, w, lower)


def _branch_value(ll, w, prior):
    """[C] log of the sum over the joint grid of exp(sum_s ll_s + w_s) times
    the prior: ``ll`` [C, G_s] and ``w`` [G_s] by sample (torch float64)."""
    c, F = prior
    total = c[None, :]  # [1, O]
    shift = 0.0
    for s, (x, ws) in enumerate(zip(ll, w)):
        x = x + ws[None, :]
        m = x.max(dim=1, keepdim=True).values  # [C, 1]
        fin = torch.isfinite(m)
        m = torch.where(fin, m, torch.zeros_like(m))
        e = torch.where(fin, torch.exp(x - m), torch.zeros_like(x))
        total = total * (e @ F[s].T)  # [C, O]
        shift = shift + m[:, 0]
    return torch.log(total.sum(dim=1)) + shift


def call_locus(sc, prior, reads, allowed, lower=False):
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
    ll_t = [torch.as_tensor(x, dtype=F64) for x in ll]
    n = [len(r["pa"]) for r in adj]
    clear = [n[si] > 10 and bool(((adj[si]["pr"] - adj[si]["pa"]) > LN_32).all())
             for si in range(n_s)]
    valid = [np.where(sc.valid[si], 0.0, -np.inf) for si in range(n_s)]

    def branch_w(spectra, si):
        if clear[si] and spectra[si].excludes_zero():
            return np.full(len(sc.values[si]), -np.inf)
        return weights(spectra[si], sc.values[si], n[si]) + valid[si]

    value = {e: torch.stack([
        _branch_value(ll_t, [torch.as_tensor(branch_w(b, si), dtype=F64) for si in range(n_s)],
                      prior)
        for b in sc.branches[e]]).numpy()  # [B, C]
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
    for b in sc.branches[best_ev]:
        h = [ll[si][0] + np.where(np.isfinite(branch_w(b, si)), 0.0, -np.inf)
             for si in range(n_s)]
        hs = [_lse(x) for x in h]
        for si in range(n_s):
            dens[si].append(h[si] + sum(hs[o] for o in range(n_s) if o != si))
    afs = [_map_af(_lse(np.stack(dens[si]), axis=0), sc.values[si].astype(np.float64))
           for si in range(n_s)]
    return post, afs


def calls(inputs, config, lower=False):
    """{(VCF position, ref, alt): ({event: probability}, {sample: AF})} of
    every locus of ``inputs``."""
    sc = Scenario(config["scenario"], config["resolution"])
    if list(inputs["samples"]) != sc.names:
        raise ValueError("the inputs' samples are not the scenario's, in its order")
    prior = prior_factors(sc)
    # an SNV allows every artifact but the homopolymer one
    allowed = [True, True, True, True, True, True, True, False, True]
    out = {}
    for i, reads in enumerate(reads_of(inputs)):
        got = call_locus(sc, prior, reads, allowed, lower)
        key = (int(inputs["pos"][i]) + 1, str(inputs["ref"][i]), str(inputs["alt"][i]))
        if got is None:
            out[key] = ({}, {name: math.nan for name in sc.names})
            continue
        post, afs = got
        out[key] = ({e: math.exp(v) for e, v in post.items()}, dict(zip(sc.names, afs)))
    return out
