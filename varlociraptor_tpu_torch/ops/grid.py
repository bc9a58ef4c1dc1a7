"""Allele-frequency grids.

The fixed dense AF grid replaces the reference's adaptive integration
(``src/utils/adaptive_integration.rs:25-141``): a per-sample
grid containing the uniform resolution lattice plus every discrete VAF that
appears in the sample's universe/events (so Set spectra are exact grid
members).  Grid cost is trivially batched on TPU; the dense lattice dominates
the reference's <=13-point adaptive scheme in accuracy (SURVEY.md 7.1.2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AFGrid:
    """Shared grid for all samples: values [G] ascending, starting at 0.0."""

    values: np.ndarray  # [G] float32

    @classmethod
    def build(cls, resolution: float = 0.01, extra_points=()):
        n = int(round(1.0 / resolution)) + 1
        pts = np.linspace(0.0, 1.0, n)
        if len(extra_points):
            pts = np.concatenate([pts, np.asarray(list(extra_points), dtype=np.float64)])
        pts = np.unique(np.round(pts, 10))
        pts = pts[(pts >= 0.0) & (pts <= 1.0)]
        return cls(values=pts.astype(np.float32))

    @property
    def size(self):
        return len(self.values)

    def index_of(self, vaf: float) -> int:
        i = int(np.argmin(np.abs(self.values - vaf)))
        if abs(float(self.values[i]) - vaf) > 1e-6:
            raise KeyError(f"VAF {vaf} not on grid")
        return i

    def set_mask(self, values) -> np.ndarray:
        """[G] bool mask with True at each set member (nearest grid point)."""
        mask = np.zeros(self.size, dtype=bool)
        for v in values:
            mask[self.index_of(v)] = True
        return mask
