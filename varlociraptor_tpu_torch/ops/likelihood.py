"""Batched per-read likelihoods (torch).

Counterpart of ``varlociraptor_tpu/ops/likelihood.py``: the elementwise
formula of the reference's ``likelihood_mapping`` and the single /
contaminated sample models, vectorized over (locus, bias combo, AF grid
point, read).  The per-read likelihood is affine in the effective
alt-sampling weight ``w = psa * nu + kappa * (1 - psa)``; with per-read
max-scaled coefficients (three exps per read, :func:`_read_terms`) every grid
cell costs a few multiply-adds and one log.

The grid forms route through K1 (``ops.ll_classes``): the grid points are
the classes, with ``nu = af`` and ``kappa = [af == 1]``.
"""

from __future__ import annotations

import math

import torch

from ..evidence.observation import F
from ..utils.logprob import NUMERICAL_EPSILON
from .ll_classes import ll_classes_folded

NEG_INF = -math.inf


def _ln1mexp(x):
    """log(1-exp(x)) for x<=0, stable, with exact -inf at x==0."""
    x = torch.clamp(x, max=0.0)
    near = x > -math.log(2.0)
    safe_expm1 = -torch.expm1(torch.where(near, x, -1.0))
    a = torch.log(torch.clamp(safe_expm1, min=1e-38))
    b = torch.log1p(-torch.exp(torch.where(near, -1.0, x)))
    out = torch.where(near, a, b)
    return torch.where(x >= 0.0, NEG_INF, out)


def _lse(x, dim):
    m = torch.amax(x, dim=dim, keepdim=True)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, 0.0)
    s = torch.log(torch.exp(x - m_safe).sum(dim=dim, keepdim=True)) + m_safe
    s = torch.where(fin, s, m)
    return s.squeeze(dim)


def _ln_add_exp(a, b):
    m = torch.maximum(a, b)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, 0.0)
    out = m_safe + torch.log1p(torch.exp(-torch.abs(a - b)))
    return torch.where(fin, out, m)


def prob_sample_alt_scaled(ln_af, prob_sample_alt):
    """af * prob_sample_alt with overshoot capping; af==1 bypasses sampling
    bias (likelihood.rs:43-53)."""
    scaled = ln_af + prob_sample_alt
    scaled = torch.where(
        (scaled > 0.0) & (scaled <= NUMERICAL_EPSILON), 0.0, scaled
    )
    return torch.where(ln_af == 0.0, 0.0, scaled)


def likelihood_mapping(ln_af, feats, bias_alt, bias_ref):
    """P(obs | af, mapped) (likelihood.rs:196-220), log-space scalar form."""
    p_alt = feats[..., F["prob_alt"]]
    p_ref = feats[..., F["prob_ref"]]
    p_sample_alt = prob_sample_alt_scaled(ln_af, feats[..., F["prob_sample_alt"]])
    p_sample_ref = _ln1mexp(p_sample_alt)
    return _ln_add_exp(
        p_sample_alt + bias_alt + p_alt,
        p_sample_ref + p_ref + bias_ref,
    )


def per_read_likelihood(ln_af, feats, bias_alt, bias_ref, bias_any):
    """Total per-read likelihood incl. mismapping term
    (likelihood.rs:171-193), log-space scalar form."""
    lm = likelihood_mapping(ln_af, feats, bias_alt, bias_ref)
    p_map = feats[..., F["prob_mapping"]]
    p_mismap = feats[..., F["prob_mismapping"]]
    p_missed = feats[..., F["prob_missed_allele"]]
    return _ln_add_exp(p_map + lm, p_mismap + p_missed + bias_any)


# ----------------------------------------------------------------------
# Affine-coefficient grid forms


def _read_terms(feats, bias_alt, bias_ref, bias_any):
    """Per-read max-scaled linear coefficients.

    feats [..., D, Fe]; bias_* [..., B, D].
    Returns (a, r, m, c) each [..., B, D] and psa_lin [..., 1, D]:
        per-read likelihood = exp(c) * (w*a + (1-w)*r + m)
    with w the effective alt-sampling weight in [0, 1].
    """
    pa = feats[..., F["prob_alt"]][..., None, :]
    pr = feats[..., F["prob_ref"]][..., None, :]
    pmap = feats[..., F["prob_mapping"]][..., None, :]
    pmm = feats[..., F["prob_mismapping"]][..., None, :]
    pmiss = feats[..., F["prob_missed_allele"]][..., None, :]
    A = pmap + bias_alt + pa  # alt path (without the w factor)
    R = pmap + bias_ref + pr  # ref path (without the 1-w factor)
    M = pmm + pmiss + bias_any  # mismapping path
    c = torch.maximum(torch.maximum(A, R), M)
    c_safe = torch.where(torch.isfinite(c), c, 0.0)
    a = torch.exp(A - c_safe)
    r = torch.exp(R - c_safe)
    m = torch.exp(M - c_safe)
    # clamp psa <= 1 (the NUMERICAL_EPSILON overshoot capping of
    # likelihood.rs:43-53 in linear space)
    psa = torch.exp(torch.clamp(feats[..., F["prob_sample_alt"]], max=0.0))
    return a, r, m, c, psa[..., None, :]


def _ll_cells(a, r, m, c, w, mask):
    """Masked read-sum of log(exp(c) * (w*a + (1-w)*r + m)) (the naive
    per-read-log branch of the reference's ``_ll_cells``).

    a/r/m/c [..., D]; w broadcastable to them; mask [..., D] bool.
    Reduces the last (read) axis."""
    w = torch.clamp(w, 0.0, 1.0)
    t = w * a + (1.0 - w) * r + m
    t = torch.where(mask, t, 1.0)
    ll = torch.log(t) + c
    return torch.where(mask, ll, 0.0).sum(dim=-1)


def sample_loglik_grid(feats, mask, bias_alt, bias_ref, bias_any, grid):
    """[L, S, B, G] log-likelihood sums over reads for every AF grid point.

    feats [L,S,D,Fe]; mask [L,S,D]; bias_* [L,S,B,D]; grid [G] f32.  Each
    sample goes through K1 with the grid points as classes."""
    kappa = (grid == 1.0).to(feats.dtype)
    out = []
    for s in range(feats.shape[1]):
        a, r, m, c, psa = _read_terms(
            feats[:, s], bias_alt[:, s], bias_ref[:, s], bias_any[:, s]
        )
        out.append(ll_classes_folded(a, r, m, c, psa, mask[:, s], grid, kappa))
    return torch.stack(out, dim=1)


def sample_loglik_grid_contaminated(
    feats, mask, bias_alt, bias_ref, bias_any, grid, ln_purity, ln_impurity
):
    """[L, B, G, G2] contaminated-sample likelihood sums
    (likelihood.rs:86-115): primary af on axis G, contaminant af on G2.

    feats [L, D, Fe], mask [L, D], bias_* [L, B, D] for ONE sample.  The
    purity-weighted mixture collapses to the affine form with
    nu = purity*af_p + impurity*af_s; the G*G2 plane goes through K1 as
    classes."""
    purity = math.exp(ln_purity)  # exp(-inf) = 0 handles fraction 0/1
    impurity = math.exp(ln_impurity)
    grid = grid.to(torch.float32)
    one = (grid == 1.0).to(torch.float32)
    pur = torch.tensor(purity, dtype=torch.float32, device=grid.device)
    imp = torch.tensor(impurity, dtype=torch.float32, device=grid.device)
    nu = pur * grid[:, None] + imp * grid[None, :]  # [G,G2]
    kappa = pur * one[:, None] + imp * one[None, :]
    G, G2 = nu.shape
    a, r, m, c, psa = _read_terms(feats, bias_alt, bias_ref, bias_any)
    ll = ll_classes_folded(
        a, r, m, c, psa, mask, nu.reshape(-1), kappa.reshape(-1)
    )
    return ll.reshape(ll.shape[0], ll.shape[1], G, G2)
