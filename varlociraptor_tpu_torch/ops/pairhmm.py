"""Batched semiglobal pair-HMM forward: the dispatcher of the realigner.

Counterpart of ``varlociraptor_tpu/ops/pairhmm.py:BatchedPairHMM``.  The
model (semiglobal: free start and end on the allele axis x, the read axis y
consumed in full):

  M(i,j) = e_m(i,j) * [ t_mm M(i-1,j-1) + t_dm D(i-1,j-1) + t_im I(i-1,j-1) ]
  D(i,j) =            [ t_md M(i-1,j)   + t_dd D(i-1,j) ]          (gap in read)
  I(i,j) = e_i(j)   * [ t_mi M(i,j-1)   + t_ii I(i,j-1) ]          (read insertion)

with e_m = 1-miscall on a match, miscall/3 on a mismatch, 1/4 against an N
read base; e_i = miscall.  ``forward`` takes the JAX package's route table
(``BatchedPairHMM.forward``, :615-692), with the port's explicit device in
place of JAX's backend, and JAX's TPU routes on both devices:

* ``VLT_HOP_STATES=1`` with ``mode="homopolymer"`` and hop params: the
  hop-state model (``_forward_hop``), on the native host library under
  ``VLT_NATIVE_PAIRHMM=1``, else the hop wavefront
  (:mod:`.pairhmm_wavefront`: its kernel on the card, its plain version on
  the CPU);
* ``VLT_NATIVE_PAIRHMM=1`` (not "0" / "false"): the native host forward
  (``_forward_native``), banded, its numeric profile ``log`` under
  ``VLT_PAIRHMM_F64LOG=1``;
* unless ``VLT_PALLAS_PAIRHMM=0``, the column kernels of
  :mod:`.pairhmm_column` over the full window: K2 for ``mode="exact"``
  with zero extension probabilities, K4 for ``mode="homopolymer"`` with
  hop params (per-position gaps), K3 when both extensions are finite;
* everything else: the banded wavefront (``_forward_impl``), or its
  positional flavour (``_forward_hp_impl``) for ``mode="homopolymer"``
  with hop params.

The JAX package takes its native route by default on its CPU backend, and
falls back to its device routes in silence when the native library does not
load.  The port runs the column kernels' plain versions on the CPU (JAX's
TPU route), and raises when the native route is asked for and the library
does not load.
"""

from __future__ import annotations

import math
import os

import numpy as np

from . import pairhmm_wavefront as wavefront
from .pairhmm_column import forward_items

NEG_INF = -1.0e30  # finite -inf proxy of the log gap params (f32-safe)


class BatchedPairHMM:
    """Pair-HMM forward over batches of (allele window, read window) items.

    mode: "exact" (full forward), "fast" (the realigner scores the
    edit-distance path on the host and reads only ``.gap``) or "homopolymer"
    (positional gaps, or the hop-state model, from ``hop_params``).
    ``device``: where the forwards run ("cuda", "cpu" or a ``torch.device``);
    without one, ``forward`` raises: the pair-HMM never picks a device on
    its own."""

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

    def _native_ok(self):
        """Whether the native host forward is asked for (``VLT_NATIVE_PAIRHMM``
        set and not "0" / "false"); raises when it is and the native library
        does not load."""
        env = os.environ.get("VLT_NATIVE_PAIRHMM")
        use = env is not None and env not in ("0", "false")
        if use:
            from ..io.native import available

            if not available():
                raise RuntimeError(
                    "the native pair-HMM was asked for (VLT_NATIVE_PAIRHMM) but the "
                    "native host library does not load (g++ and zlib are needed)"
                )
        return use

    def _use_hop_states(self):
        """Opt-in (``VLT_HOP_STATES=1``) hop-state homopolymer HMM: the
        reconstruction of rust-bio's HomopolyPairHMM with per-base hop lanes
        (native ``vlt_pairhmm_hop_one`` and the hop wavefront).  The
        positional-gap approximation stays the default, as in the JAX
        package (its ``_use_hop_states`` docstring says why)."""
        return (
            self.mode == "homopolymer"
            and self.hop is not None
            and os.environ.get("VLT_HOP_STATES", "0") == "1"
        )

    def route(self):
        """The route ``forward`` takes now: "hop_native", "hop_wavefront",
        "native", "exact" (K2), "positional" (K4), "general" (K3),
        "positional_wavefront" or "banded_wavefront"."""
        if self._use_hop_states():
            return "hop_native" if self._native_ok() else "hop_wavefront"
        if self._native_ok():
            return "native"
        hop = self.mode == "homopolymer" and self.hop is not None
        if os.environ.get("VLT_PALLAS_PAIRHMM") != "0":
            if (self.mode == "exact" and self.gap[2] <= NEG_INF / 2
                    and self.gap[3] <= NEG_INF / 2):
                return "exact"
            if hop:
                return "positional"
            if self.gap[2] > NEG_INF / 2 and self.gap[3] > NEG_INF / 2:
                return "general"
        return "positional_wavefront" if hop else "banded_wavefront"

    def forward(self, alleles, reads, quals, max_dists=None):
        """alleles: list[bytes-like]; reads: list[bytes-like];
        quals: list[uint8 array]; max_dists: optional list[int|None] band
        per item (None = full forward; ints reproduce rust-bio's banded
        pruning with max_edit_dist = hit.dist + EDIT_BAND), read by the
        wavefront and native routes; the column kernels run the full
        window.  Returns np.float64 [n] log-probs."""
        n_req = len(alleles)
        if not n_req == len(reads) == len(quals):
            raise ValueError("alleles, reads and quals differ in length")
        if max_dists is not None and len(max_dists) != n_req:
            raise ValueError("max_dists differs in length from alleles")
        if self.device is None:
            raise RuntimeError(
                "BatchedPairHMM has no device: pass device='cuda' or 'cpu'"
            )
        route = self.route()
        if route in ("hop_native", "hop_wavefront"):
            return self._forward_hop(alleles, reads, quals, max_dists)
        if route == "native":
            return self._forward_native(alleles, reads, quals, max_dists)
        if route in ("exact", "general", "positional"):
            hop = self.hop if route == "positional" else None
            return forward_items(alleles, reads, quals, self.gap, self.device,
                                 general=route == "general", hop=hop)
        hop = self.hop if route == "positional_wavefront" else None
        return wavefront.forward_items(alleles, reads, quals, max_dists, self.gap,
                                       self.device, hop=hop)

    def _forward_hop(self, alleles, reads, quals, max_dists=None):
        """The hop-state homopolymer forward (JAX :757-820): the native host
        library under ``VLT_NATIVE_PAIRHMM=1``, else the hop wavefront on
        ``self.device``."""
        if self._native_ok():
            from ..io.native import pairhmm_hop_batch

            miscalls = [
                -np.asarray(q, dtype=np.float32) * np.float32(math.log(10.0) / 10.0)
                for q in quals
            ]
            out = pairhmm_hop_batch(
                [bytes(a) for a in alleles], reads, miscalls, self.gap, wavefront.hop16(self.hop),
                max_edit=max_dists,
            )
            if out is None:
                raise RuntimeError("the native hop-state pair-HMM failed")
            return out
        return wavefront.forward_items(alleles, reads, quals, max_dists, self.gap,
                                       self.device, hop=self.hop, hop_states=True)

    def _forward_native(self, alleles, reads, quals, max_dists=None):
        """The native C++ host forward (``io/native.py``; JAX :822-882): the
        same model per item at its exact lengths, banded by ``max_dists``;
        ``VLT_PAIRHMM_F64LOG=1`` selects the float64 log-space profile."""
        from ..io.native import pairhmm_forward_batch

        miscalls = [
            -np.asarray(q, dtype=np.float32) * np.float32(math.log(10.0) / 10.0)
            for q in quals
        ]
        kw = {}
        if self.mode == "homopolymer" and self.hop is not None:
            ins_open, ins_ext, del_open, del_ext = [], [], [], []
            for a, r in zip(alleles, reads):
                rarr = np.frombuffer(
                    bytes(bytearray(np.asarray(r, dtype=np.uint8))), dtype=np.uint8
                )[None, :]
                aarr = np.frombuffer(bytes(a), dtype=np.uint8)[None, :]
                io_, ie_ = wavefront.positional_gaps(
                    rarr & ~np.uint8(0x20), self.gap[0], self.gap[2],
                    self.hop.prob_seq_homopolymer, self.hop.prob_seq_extend_homopolymer,
                )
                do_, de_ = wavefront.positional_gaps(
                    aarr & ~np.uint8(0x20), self.gap[1], self.gap[3],
                    self.hop.prob_ref_homopolymer, self.hop.prob_ref_extend_homopolymer,
                )
                ins_open.append(io_[0])
                ins_ext.append(ie_[0])
                del_open.append(do_[0])
                del_ext.append(de_[0])
            kw = dict(ins_open=ins_open, ins_ext=ins_ext, del_open=del_open,
                      del_ext=del_ext)
        profile = "log" if os.environ.get("VLT_PAIRHMM_F64LOG") == "1" else "linear"
        out = pairhmm_forward_batch(
            alleles, reads, miscalls, self.gap, max_edit=max_dists, profile=profile, **kw
        )
        if out is None:
            raise RuntimeError("the native pair-HMM failed")
        return out
