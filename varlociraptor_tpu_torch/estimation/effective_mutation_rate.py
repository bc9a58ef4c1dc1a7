"""Effective mutation rate estimation (Williams et al. neutral model).

Port of ``src/estimation/effective_mutation_rate.rs:32-84``:
linear regression of the cumulative number of mutations M(f) against
1/f - 1/fmax; the slope is mu/beta (effective mutation rate per effective
cell division).
"""

from __future__ import annotations

import numpy as np


def estimate(afs, min_af: float = 0.12, max_af: float = 0.25):
    """afs: iterable of allele frequencies of somatic mutations.

    Returns dict with slope (mu/beta), intercept, and the fitted curve.
    """
    afs = np.asarray([a for a in afs if min_af <= a <= max_af], dtype=np.float64)
    if len(afs) < 2:
        return {"mu_per_beta": float("nan"), "intercept": float("nan"), "n": len(afs)}
    # effective_mutation_rate.rs:35-56: group by UNIQUE reciprocal frequency
    # (BTreeMap keyed on 1/f), regress the cumulative mutation count M(1/f)
    # on 1/f over one point per distinct frequency (duplicates only raise
    # the cumulative count, they do not get extra regression weight)
    recip, counts = np.unique(1.0 / afs, return_counts=True)
    ms = np.cumsum(counts).astype(np.float64)
    slope, intercept = np.polyfit(recip, ms, 1)
    return {
        "mu_per_beta": float(slope),
        "intercept": float(intercept),
        "n": int(len(afs)),
    }
