"""Batched semiglobal pair-HMM forward: the dispatcher of the realigner.

Counterpart of ``varlociraptor_tpu/ops/pairhmm.py:BatchedPairHMM``.  The
model (semiglobal: free start and end on the allele axis x, the read axis y
consumed in full):

  M(i,j) = e_m(i,j) * [ t_mm M(i-1,j-1) + t_dm D(i-1,j-1) + t_im I(i-1,j-1) ]
  D(i,j) =            [ t_md M(i-1,j)   + t_dd D(i-1,j) ]          (gap in read)
  I(i,j) = e_i(j)   * [ t_mi M(i,j-1)   + t_ii I(i,j-1) ]          (read insertion)

with e_m = 1-miscall on a match, miscall/3 on a mismatch, 1/4 against an N
read base; e_i = miscall.  ``forward`` runs the full window on an explicit
device through the column kernels of :mod:`.pairhmm_column`:

* zero extension probabilities (the default ``GapParams``): K2;
* any finite extension (e.g. the MLE rates ``estimate()`` gives on real
  data): K3;
* ``mode="homopolymer"`` with hop params, whatever the gap model: K4, with
  per-position gaps (the hop rates inside homopolymer runs, built on the
  device by :func:`.pairhmm_column.positional_gaps`); without hop params
  (``estimate()`` found too few homopolymer indels) the mode falls through
  to K2 / K3, as in the JAX package.

Like the JAX package's kernel path, it ignores the ``max_dists`` band: the
band only prunes probability mass that the full forward dominates.
"""

from __future__ import annotations

import math

import numpy as np

from .pairhmm_column import forward_items

NEG_INF = -1.0e30  # finite -inf proxy of the log gap params (f32-safe)


class BatchedPairHMM:
    """Pair-HMM forward over batches of (allele window, read window) items.

    mode: "exact" (full forward), "fast" (the realigner scores the
    edit-distance path on the host and reads only ``.gap``) or "homopolymer"
    (positional gaps from ``hop_params``).  ``device``: where
    the forwards run ("cuda", "cpu" or a ``torch.device``); without one,
    ``forward`` raises: the pair-HMM never picks a device on its own."""

    def __init__(self, gap_params, hop_params=None, mode: str = "exact", device=None):
        self.mode = mode
        self.hop = hop_params
        self.device = device
        self._init_gaps(gap_params)

    def _init_gaps(self, gap_params):
        # zero (= -inf log) extension probability means multi-base spurious
        # gaps are impossible through the gap states (rust-bio semantics:
        # X->X only via the extension transition) — the default model, where
        # gaps model per-base sequencing errors and real indels live in the
        # alt-allele emission instead.
        def _f(x):
            return x if math.isfinite(x) else NEG_INF

        self.gap = np.array(
            [
                _f(gap_params.prob_insertion_artifact),
                _f(gap_params.prob_deletion_artifact),
                _f(gap_params.prob_insertion_extend_artifact),
                _f(gap_params.prob_deletion_extend_artifact),
            ],
            dtype=np.float32,
        )

    def forward(self, alleles, reads, quals, max_dists=None):
        """alleles: list[bytes-like]; reads: list[bytes-like];
        quals: list[uint8 array]; max_dists: the per-item band, accepted for
        the realigner's interface and not used (full-window forward).
        Returns np.float64 [n] log-probs."""
        n_req = len(alleles)
        if not n_req == len(reads) == len(quals):
            raise ValueError("alleles, reads and quals differ in length")
        if max_dists is not None and len(max_dists) != n_req:
            raise ValueError("max_dists differs in length from alleles")
        if self.device is None:
            raise RuntimeError(
                "BatchedPairHMM has no device: pass device='cuda' or 'cpu'"
            )
        # zero extension in both gap states: the collapsed one-state K2
        zero_ext = self.gap[2] <= NEG_INF / 2 and self.gap[3] <= NEG_INF / 2
        hop = self.hop if self.mode == "homopolymer" else None
        return forward_items(
            alleles, reads, quals, self.gap, self.device, general=not zero_ext, hop=hop
        )
