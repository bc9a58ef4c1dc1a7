"""Tensor event programs: the compiled form of scenario events.

The reference interprets a ``VAFTree`` per event at runtime with recursive
adaptive integration (``src/grammar/vaftree.rs``,
``.../modes/generic.rs:191-422``).  The TPU design compiles each event into a
flat *event program*: a sum over root-to-leaf paths ("branches"), where each
branch assigns every sample one VAF spectrum (a discrete set or a range), a
set of SNV-selector gates, and pairwise log2-fold-change constraints.  Branch
integrals become masked logsumexp/trapezoid reductions over a fixed
allele-frequency grid — fully batched over loci.

Flattening is exact: a VAF tree path visits each sample at most once (the
formula normalizer merges same-sample atoms), so the tree's sum-product
structure equals the sum over paths of per-sample factor products.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SPECTRUM_SET = 0
SPECTRUM_RANGE = 1


@dataclass(frozen=True)
class SpectrumSpec:
    """A per-sample VAF spectrum (formula.rs:1018-1120)."""

    kind: int
    # for SET:
    values: tuple = ()
    # for RANGE:
    start: float = 0.0
    end: float = 0.0
    left_exclusive: bool = False
    right_exclusive: bool = False

    @classmethod
    def from_set(cls, values):
        return cls(kind=SPECTRUM_SET, values=tuple(sorted(set(float(v) for v in values))))

    @classmethod
    def from_range(cls, start, end, left_exclusive=False, right_exclusive=False):
        if start == end and not (left_exclusive or right_exclusive):
            return cls.from_set([start])
        return cls(
            kind=SPECTRUM_RANGE,
            start=float(start),
            end=float(end),
            left_exclusive=bool(left_exclusive),
            right_exclusive=bool(right_exclusive),
        )

    @property
    def is_set(self):
        return self.kind == SPECTRUM_SET

    @property
    def is_empty(self):
        if self.is_set:
            return len(self.values) == 0
        return self.start == self.end and (self.left_exclusive or self.right_exclusive)

    def contains(self, vaf: float) -> bool:
        if self.is_set:
            return any(abs(v - vaf) < 1e-9 for v in self.values)
        lo_ok = vaf > self.start if self.left_exclusive else vaf >= self.start
        hi_ok = vaf < self.end if self.right_exclusive else vaf <= self.end
        return lo_ok and hi_ok

    def min_vaf(self) -> float:
        return min(self.values) if self.is_set else self.start

    def max_vaf(self) -> float:
        return max(self.values) if self.is_set else self.end


@dataclass(frozen=True)
class SnvGate:
    """Variant-selector node (vaftree.rs NodeKind::Variant): branch applies
    only when the candidate SNV's (ref, alt) bases match (or don't, when
    negated)."""

    positive: bool
    ref_bases: frozenset  # of single-char strings (IUPAC expanded)
    alt_bases: frozenset

    def passes(self, snv) -> bool:
        """snv: None or (refbase, altbase) chars."""
        if snv is None:
            return not self.positive
        ref, alt = snv
        contains = ref.upper() in self.ref_bases and alt.upper() in self.alt_bases
        return contains if self.positive else not contains


@dataclass(frozen=True)
class LfcConstraint:
    """log2(vaf_a / vaf_b) cmp value (utils/log2_fold_change.rs)."""

    sample_a: int
    sample_b: int
    op: str  # one of "==", "<", "<=", ">", ">="
    value: float

    def holds(self, vaf_a: float, vaf_b: float) -> bool:
        if vaf_b == 0.0 or vaf_a == 0.0:
            lfc = (
                np.inf
                if vaf_b == 0.0 and vaf_a > 0.0
                else (-np.inf if vaf_a == 0.0 and vaf_b > 0.0 else 0.0)
            )
        else:
            lfc = np.log2(vaf_a / vaf_b)
        return {
            "==": bool(np.isclose(lfc, self.value)),
            "!=": not bool(np.isclose(lfc, self.value)),
            "<": lfc < self.value,
            "<=": lfc <= self.value,
            ">": lfc > self.value,
            ">=": lfc >= self.value,
        }[self.op]


@dataclass(frozen=True)
class BranchSpec:
    """One root-to-leaf path of a VAF tree: per-sample spectra + gates."""

    spectra: tuple  # tuple[SpectrumSpec], len n_samples
    snv_gates: tuple = ()
    lfcs: tuple = ()

    def passes_snv(self, snv) -> bool:
        return all(g.passes(snv) for g in self.snv_gates)


@dataclass(frozen=True)
class EventSpec:
    """A scenario event compiled to branches (plus artifact twin flag)."""

    name: str
    branches: tuple  # tuple[BranchSpec]
    is_artifact: bool = False

    def all_absent(self) -> bool:
        return all(
            sp.is_set and sp.values == (0.0,)
            for br in self.branches
            for sp in br.spectra
        )


def absent_event(n_samples: int, name: str = "absent") -> EventSpec:
    """VAFTree::absent (vaftree.rs:18-40)."""
    return EventSpec(
        name=name,
        branches=(
            BranchSpec(spectra=tuple(SpectrumSpec.from_set([0.0]) for _ in range(n_samples))),
        ),
    )
