"""The roofline of the engine's l2fc integrals, from the work the
mathematics defines (the program's ``engine.lfc_cells`` and
``engine.lfc_bytes`` counters), not from how its slabs implement it: a
later kernel that never writes the slab is held to the same bound.

Each cell of an integral's joint grid is two adds (the pair's terms and
the predicate's log mask), the running maximum, the subtract and the
accumulate, five float32 operations, and one exponential.  The bound is
the larger of the operations over the float32 peak, the exponentials over
the special-function units' rate, and the bytes over the memory rate.
"""

from __future__ import annotations

from .roofline import PEAK_BYTES, PEAK_F32_OPS

LFC_OPS_PER_CELL = 5
# NVIDIA H100 SXM: 132 SMs, 16 special-function results an SM a clock
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0), at the 1.98 GHz boost clock
PEAK_EXP = 132 * 16 * 1.98e9


def lfc_roofline(cells, nbytes):
    """The least time the card could take for ``cells`` joint grid cells
    and ``nbytes`` bytes, and which of the three terms binds."""
    terms = {"operations": LFC_OPS_PER_CELL * cells / PEAK_F32_OPS,
             "exponentials": cells / PEAK_EXP, "bytes": nbytes / PEAK_BYTES}
    bound_by = max(terms, key=terms.get)
    return {"cells": cells, "bytes": nbytes, "bound_s": terms[bound_by], "bound_by": bound_by}
