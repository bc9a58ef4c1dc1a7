"""The roofline of the engine's --full-prior pass, from the work the
mathematics defines (the program's ``engine.full_prior_cells`` and
``engine.full_prior_bytes`` counters), not from how its slabs implement it:
a later kernel that skips the cells no branch weighs is held to the same
bound.

Each counted cell (a joint grid point that every sample's branch weight
leaves finite, at a locus, active combination and branch) is one
multiply-add of the prior into the branch's sum, two float32 operations.
No exponential is counted: a contraction in exponential space, with each
axis shifted by its largest value, needs none per cell.  The bound is the
larger of the operations over the float32 peak and the bytes over the
memory rate.
"""

from __future__ import annotations

from .roofline import PEAK_BYTES, PEAK_F32_OPS

FULL_PRIOR_OPS_PER_CELL = 2


def full_prior_roofline(cells, nbytes):
    """The least time the card could take for ``cells`` joint grid cells
    and ``nbytes`` bytes, and which of the two terms binds."""
    terms = {"operations": FULL_PRIOR_OPS_PER_CELL * cells / PEAK_F32_OPS,
             "bytes": nbytes / PEAK_BYTES}
    bound_by = max(terms, key=terms.get)
    return {"cells": cells, "bytes": nbytes, "bound_s": terms[bound_by], "bound_by": bound_by}
