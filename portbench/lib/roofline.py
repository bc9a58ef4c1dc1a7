"""The benchmark's roofline arithmetic, frozen from ``chip_smoke.py`` (commit
8830722): the published peaks of one NVIDIA H100 SXM and the operations
and bytes each kernel needs, counted from the shapes of its launch.

A kernel's roofline share is the least time the card could take (the
larger of operations over the float32 peak and bytes over the memory
rate) over the time the kernel took; it cannot pass 100% unless the
operations or bytes are counted too high or the time leaves work out.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet at 700 W: float32 outside the tensor cores,
# and HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations, an FMA counted as 2 as the peak counts it.  K1 per
# (row, class, read): w = clip(p * (nu - kappa) + kappa, 0, 1) (one FMA, the
# clip a saturate), t = w * (a - r) + (r + m) (one FMA), the log and the read
# sum: 6; a - r and r + m once per (row, read), nu - kappa once per class.
K1_OPS_PER_CELL = 6
# K2 / K3 / K4 per (allele row, read base) of their column recurrences
# (ops/pairhmm_column.py plain versions)
OPS_PER_CELL = {"exact": 7, "general": 16, "positional": 19}


def roofline(ops, nbytes):
    """The least time the card could take: operations over the float32
    peak or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return {"ops": ops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_roofline(N, U, D):
    """K1's bound at rows N, classes U, reads D: every (row, class, read)
    cell, the inputs a, r, m, psa [N, D] and nu, kappa [U] read once and the
    [N, U] float32 output written once."""
    return roofline(K1_OPS_PER_CELL * N * U * D + 2 * N * D + U,
                    4 * (4 * N * D + 2 * U + N * U))


def pairhmm_roofline(kind, cells, input_bytes, n_items):
    """K2 / K3 / K4's bound on a launch: ``cells`` (allele length x read
    length summed over the items), every input read once (``input_bytes``)
    and the [n_items] float32 output written once."""
    return roofline(OPS_PER_CELL[kind] * cells, input_bytes + 4 * n_items)
