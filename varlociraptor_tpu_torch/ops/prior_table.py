"""The --full-prior joint prior table, over the whole joint grid at once.

``Prior.compute`` (``ops/prior.py``, ``prior.rs:298-438``) evaluates the
prior of one per-sample VAF vector: a nested sum over each sample's
germline genotypes (a sample with a somatic rate takes every allele count
of its ploidy; a germline-only sample takes its VAF itself, if it lies on
the ploidy's lattice; a sample with a universe takes 0, if the universe
holds its VAF) of the terminal terms: the population germline prior of the
samples without inheritance (``prior.rs:554-582``), and per sample the flat
somatic mass (``:440-456``), the Mendelian meiotic-split hypergeometrics
with the de novo rate (``:600-712``), or the clonal / subclonal terms
(``:458-552``).  :func:`joint_prior_table` computes the same sums for every
cell of the grid in float64 numpy, one germline genotype combination at a
time: each terminal term is a constant, a lookup on small integer allele
counts or a comparison along one or two axes, broadcast over the grid, and
added in the scalar's order.  The integer lookups (population prior,
Mendelian term) call the scalar's own functions once per distinct count, so
the terms are the scalar's to the bit; only the sums over genotypes round
through numpy's ``exp`` / ``log`` instead of ``math``'s.
"""

from __future__ import annotations

import math

import numpy as np

from .prior import LOG_ZERO, _ln1m, _ln_sum


def _round9(values):
    """``Prior.compute``'s key rounding (``round(v, 9)``) of each value."""
    return np.array([round(float(v), 9) for v in values], dtype=np.float64)


def _sample_options(prior, s, v):
    """Sample ``s``'s germline genotypes as ``_calc_prob`` enumerates them:
    [(germline VAF, valid [G_s])], the germline VAF a number, or per grid
    point of the sample's axis ``v`` where it is the VAF itself."""
    ploidy = prior.ploidies[s]
    valid = np.ones(len(v), bool) if ploidy != 0 else v == 0.0
    if prior.uniform[s]:
        holds = np.array([any(u.contains(x) for u in prior.universes[s]) for x in v], bool)
        return [(0.0, valid & holds)]
    if prior.somatic_effective_mutation_rate[s] is not None:
        if ploidy is None:
            raise ValueError("sample with somatic mutation rate but no ploidy")
        return [(n_alt / ploidy if ploidy > 0 else 0.0, valid)
                for n_alt in range(ploidy + 1)]
    if ploidy is not None and prior.heterozygosity is not None:
        n_alt = ploidy * v
        return [(v, valid & (np.abs(n_alt - np.rint(n_alt)) < 1e-6))]
    raise ValueError("not enough info for prior but no universe specified")


def _somatic(ln_rate, somatic_vaf):
    """``Prior._prob_somatic_mutation`` elementwise."""
    return np.where(np.abs(somatic_vaf) < 1e-9, _ln1m(ln_rate), ln_rate)


def _lookup(fn, *counts):
    """``fn(*ints)`` at each element of the broadcast integer arrays
    ``counts``, called once per distinct combination."""
    counts = np.broadcast_arrays(*[np.asarray(c, dtype=np.int64) for c in counts])
    stacked = np.stack([c.ravel() for c in counts], axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    vals = np.array([fn(*(int(x) for x in row)) for row in uniq], dtype=np.float64)
    return vals[inv.reshape(-1)].reshape(counts[0].shape)


def _terminal(prior, ev, gv):
    """``Prior._prob_terminal`` at the event VAFs ``ev`` and germline VAFs
    ``gv`` (per sample, arrays broadcast over the joint grid)."""
    S = prior.n_samples
    prob = 0.0
    het = prior._vartype_het()
    if het is not None:
        pop = [s for s in range(S) if prior.inheritance[s] is None
               and prior.ploidies[s] is not None and not prior.uniform[s]]
        n = sum(prior.ploidies[s] for s in pop)

        def population(mm):
            # Prior._prob_population_germline at mm alternative alleles
            if mm > 0:
                return het - math.log(mm)
            if n == 0:
                return 0.0
            return _ln1m(_ln_sum([het - math.log(k) for k in range(1, n + 1)]))

        m = sum((np.rint(prior.ploidies[s] * gv[s]) for s in pop), np.zeros(()))
        prob = prob + _lookup(population, m)
    for s in range(S):
        if prior.uniform[s]:
            continue
        inh = prior.inheritance[s]
        rate = prior._vartype_somatic_rate(s)
        sv = ev[s] - gv[s]
        if inh is None:
            if rate is not None:
                prob = prob + _somatic(rate, sv)
        elif inh.kind == "mendelian":
            germline_rate = prior._vartype_germline_rate(s)
            if germline_rate is None:
                raise ValueError("no germline mutation rate for child")
            p0, p1 = inh.from_samples
            pl = prior.ploidies
            term = _lookup(
                lambda a0, a1, c: prior._prob_mendelian_alt_counts(
                    (pl[p0], pl[p1]), pl[s], (a0, a1), c, germline_rate),
                np.rint(gv[p0] * pl[p0]), np.rint(gv[p1] * pl[p1]), np.rint(gv[s] * pl[s]))
            if rate is not None:
                term = term + _somatic(rate, sv)
            prob = prob + term
        elif inh.kind in ("clonal", "subclonal"):
            p = inh.from_samples[0]
            pv = ev[p] - gv[p]
            if inh.kind == "clonal":
                if inh.somatic:
                    term = (np.where(np.abs(pv) > 1e-9, 0.0, _somatic(rate, sv))
                            if rate is not None
                            else np.where(np.abs(sv - pv) < 1e-9, 0.0, LOG_ZERO))
                else:
                    term = _somatic(rate, sv) if rate is not None else np.zeros(())
            elif rate is not None:
                term = np.where((ev[p] == 0.0) & (gv[s] == 0.0), _somatic(rate, ev[s]), 0.0)
            else:
                term = np.where(np.abs(sv - pv) < 1e-9, 0.0, LOG_ZERO)
            prob = prob + np.where(np.abs(gv[s] - gv[p]) > 1e-9, LOG_ZERO, term)
    prob = np.asarray(prob, dtype=np.float64)
    if np.any(prob > 1e-9):
        raise AssertionError(f"prior > 1: {prob.max()}")
    return np.minimum(prob, 0.0)


def _ln_sum_np(parts):
    """``_ln_sum`` over the first axis of the list ``parts`` (arrays of one
    shape), elementwise, summing in the list's order."""
    m = parts[0]
    for p in parts[1:]:
        m = np.maximum(m, p)
    fin = m != LOG_ZERO
    ms = np.where(fin, m, 0.0)
    acc = np.exp(parts[0] - ms)
    for p in parts[1:]:
        acc = acc + np.exp(p - ms)
    with np.errstate(divide="ignore"):
        return np.where(fin, ms + np.log(acc), LOG_ZERO)


def joint_prior_table(prior, value_lists) -> np.ndarray:
    """float64 [G_0, ..., G_{S-1}]: ``prior.compute`` with
    ``is_absent_only`` false at every cell of the grid whose axes are
    ``value_lists`` (the engine's per-sample active subgrids), with the
    prior's current per-variant overrides."""
    S = prior.n_samples
    vals = [_round9(v) for v in value_lists]
    shape = tuple(len(v) for v in vals)

    def axis(s, a):
        sh = [1] * S
        sh[s] = len(a)
        return np.asarray(a).reshape(sh)

    ev = [axis(s, vals[s]) for s in range(S)]
    options = [[(np.float64(g) if np.ndim(g) == 0 else axis(s, g), axis(s, ok))
                for g, ok in _sample_options(prior, s, vals[s])]
               for s in range(S)]

    def nested(s, gv, valid):
        # _calc_prob's recursion: sample s's genotypes summed in order
        if s == S:
            return np.where(valid, _terminal(prior, ev, gv), LOG_ZERO)
        parts = [np.broadcast_to(nested(s + 1, gv + [g], valid & ok), shape)
                 for g, ok in options[s]]
        return parts[0] if len(parts) == 1 else _ln_sum_np(parts)

    return np.broadcast_to(nested(0, [], np.ones((1,) * S, bool)), shape).copy()

