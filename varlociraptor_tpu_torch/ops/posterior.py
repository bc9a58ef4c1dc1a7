"""Grid posterior engine (torch): batched Bayesian event evaluation.

Counterpart of ``varlociraptor_tpu/ops/posterior.py`` in every mode of the
reference's engine: contamination forests and cycles, l2fc constraints and
the ``--full-prior`` joint prior.  Per event and branch (= flattened tree
path):

  value = bias_prior + prior_event + logsumexp_{joint grid} [
              sum_s (loglik_s[g_s] + weights_s[g_s]) ]

with per-sample integration weights computed from the per-locus depth, the
clear-ref shortcut, and the absent-only prior applied exactly by splitting
out the all-zero joint grid point.  Contamination pairs are contracted by
tree variable elimination, each child axis as a shifted-exp einsum; a
contamination cycle of length >= 3 keeps a two-axis frontier around the
cycle.  Branches with l2fc constraints re-contract the constrained samples
jointly under pairwise grid masks, and ``--full-prior`` evaluates the prior
pointwise on the joint grid.  The reference's ``lax.scan`` contractions are
plain loops over the scanned grid axis with a float32 ``logaddexp`` carry.

The host setup (per-sample active subgrids, spectra, support classes, the
unique (nu, kappa) classes of each contaminated plane) is a numpy copy of the
reference's and yields the same tables bit for bit (``convert.py``).  The
device code is plain torch on ``self.device``; the contaminated-plane and
grid likelihoods go through the K1 kernel (``ops.ll_classes``), and the
event and MAP / AFD pass through ``ops.assemble``.

Outputs of :meth:`PosteriorEngine.run` / :meth:`run_wire` are host numpy
arrays with the keys and dtypes of the reference's ``_unpack_host``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..ops.event_program import SPECTRUM_SET, EventSpec
from ..ops.grid import AFGrid

from .. import tracing
from ..device import resolve_device
from ..evidence.observation import F
from .assemble import AssembleTables, assemble_head, assemble_tail
from .lfc_star import lfc_star
from .likelihood import (
    NEG_INF,
    _ln1mexp,
    _ln_add_exp,
    _lse,
    _read_terms,
    sample_loglik_grid,
)
from .ll_classes import ll_classes_folded
from .lse_contract import class_table, lse_contract

LN_32 = math.log(3.2)  # Kass-Raftery "positive" threshold

# AFD points shipped to the host per (locus, sample): the K densest subgrid
# points plus a static strided backbone across the whole subgrid.
AFD_TOP_K = 16
AFD_BACKBONE_K = 16

# the largest [Lc,B,NB,G1,G2] float32 slab of the --full-prior trio loop: the
# locus axis is cut into chunks that keep each within it (two live at once)
_FULL_PRIOR_SLAB_BYTES = 1 << 31

_TORCH_DTYPES = {
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
}


def _ln_sub_exp(a, b):
    """log(exp(a) - exp(b)) for a >= b (clamped at -inf)."""
    out = a + _ln1mexp(torch.clamp(b - a, max=0.0))
    return torch.where(b >= a, NEG_INF, out)


def observable_bounds(start, end, left_excl, right_excl, n_obs):
    """VAFRange::observable_min/max (formula.rs:1172-1232). All args
    broadcast together; n_obs float."""
    n = torch.clamp(n_obs, min=1.0)
    possible = (end - start) * n_obs > 1.0
    small_n = n_obs < 10.0
    raw = small_n | ~possible

    # observable_max
    c_max = n_obs * end
    is_int_max = torch.abs(c_max - torch.round(c_max)) < 1e-9
    c_max = torch.where(right_excl & is_int_max, c_max - 1.0, c_max)
    c_max = torch.floor(c_max + 1e-9)
    amax = torch.where(raw | (c_max == 0.0), end, c_max / n)

    # observable_min
    c_min = n_obs * start
    adj_min = torch.ceil(c_min - 1e-9) / n
    is_int_min = torch.abs(c_min - torch.round(c_min)) < 1e-9
    cand1 = (c_min + 1.0) / n
    cand0 = c_min / n
    excl_min = torch.where((cand1 <= 1.0) & (cand1 <= amax), cand1, cand0)
    amin = torch.where(left_excl & is_int_min, excl_min, adj_min)
    amin = torch.where(raw, start, amin)
    amin = torch.where(amin >= amax, start, amin)
    return amin, amax


def range_weights(grid, start, end, left_excl, right_excl, n_obs):
    """[..., G] log trapezoid weights for a range spectrum restricted to
    [observable_min, observable_max]. Leading dims come from the args."""
    amin, amax = observable_bounds(start, end, left_excl, right_excl, n_obs)
    amin = amin[..., None]
    amax = amax[..., None]
    inside = (grid >= amin - 1e-9) & (grid <= amax + 1e-9)
    left_in = torch.cat(
        [torch.zeros_like(inside[..., :1]), inside[..., :-1]], dim=-1
    )
    right_in = torch.cat(
        [inside[..., 1:], torch.zeros_like(inside[..., :1])], dim=-1
    )
    gl = torch.where(left_in, torch.cat([grid[:1], grid[:-1]]), grid)
    gr = torch.where(right_in, torch.cat([grid[1:], grid[-1:]]), grid)
    width = torch.clamp(gr - gl, min=0.0) * 0.5
    run_len = inside.sum(dim=-1, keepdim=True)
    single_width = torch.clamp(amax - amin, min=1e-12)
    width = torch.where(run_len <= 1, single_width, width)
    return torch.where(
        inside & (width > 0), torch.log(torch.clamp(width, min=1e-38)), NEG_INF
    )


def _lfc_components(lfc_list):
    """Connected components of a branch's l2fc constraint graph (nodes =
    samples, edges = pairwise masks)."""
    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, _ in lfc_list:
        parent[find(a)] = find(b)
    groups = {}
    for entry in lfc_list:
        groups.setdefault(find(entry[0]), []).append(entry)
    return list(groups.values())


def _stream_mark(dev):
    """A point on ``dev``'s stream: a timed CUDA event recorded there, or
    the host clock in ns where the device computes as the host calls it."""
    if dev.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(dev))
        return event
    return time.perf_counter_ns()


def _stream_ns(start, end):
    """Nanoseconds between two completed :func:`_stream_mark` points."""
    if isinstance(start, int):
        return end - start
    return round(start.elapsed_time(end) * 1e6)


def _log_mask(m):
    """0 where a bool mask holds, -inf elsewhere (float32)."""
    return np.where(np.asarray(m), 0.0, -np.inf).astype(np.float32)


class SampleConfig:
    def __init__(
        self,
        name,
        contaminated_by=None,
        contamination_fraction=0.0,
        resolution=None,
    ):
        self.name = name
        self.contaminated_by = contaminated_by
        self.contamination_fraction = contamination_fraction
        # per-sample integration resolution (scenario `resolution:` field,
        # generic.rs:357); None = the shared engine grid
        self.resolution = resolution


def _pair_class_setup(child_values, parent_values, fraction):
    """Unique (nu, kappa) classes of the contaminated-likelihood plane.

    Returns (nu_u [U] f32, kappa_u [U] f32, inv [Ac,Ap] int32) with
    plane[g_child, g_parent] = class inv[gc, gp]."""
    pur = np.float32(1.0 - fraction)
    imp = np.float32(fraction)
    gc = np.asarray(child_values, dtype=np.float32)
    gp = np.asarray(parent_values, dtype=np.float32)
    nu = pur * gc[:, None] + imp * gp[None, :]
    onec = (gc == 1.0).astype(np.float32)
    onep = (gp == 1.0).astype(np.float32)
    kappa = pur * onec[:, None] + imp * onep[None, :]
    pairs = np.stack([nu.ravel(), kappa.ravel()], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    return (
        uniq[:, 0].copy(),
        uniq[:, 1].copy(),
        inv.reshape(nu.shape).astype(np.int32),
    )


def _pair_loglik_classes(feats, mask, bias_alt, bias_ref, bias_any, nu_u, kappa_u):
    """[L, B, U] contaminated likelihood sums on the unique classes, through
    K1.  feats [L,D,Fe]; bias [L,B,D]; nu_u/kappa_u [U]."""
    a, r, m, c, psa = _read_terms(feats, bias_alt, bias_ref, bias_any)
    return ll_classes_folded(a, r, m, c, psa, mask, nu_u, kappa_u)


class _Pending:
    """Engine results in flight to the host: pinned host tensors filled by
    non-blocking copies, and the CUDA event recorded after those copies on
    the dispatching stream (None on the CPU).  Any thread may finish it."""

    def __init__(self, host, event, L, marks, counts=()):
        self.host = host
        self.event = event
        self.L = L
        # traced: (counter, start, end) stream marks of the run's l2fc,
        # full-prior and assemble passes, and (counter, host tensor) counts
        # computed on the device
        self.marks = marks
        self.counts = counts


class PosteriorEngine:
    """Engine for one scenario (event set + grid + contamination), holding
    its constant tables as tensors on an explicit ``device``."""

    def __init__(
        self,
        events: list[EventSpec],
        grid: AFGrid,
        samples: list[SampleConfig],
        resolution: float = 0.01,
        all_uniform_prior: bool = False,
        valid_vaf_mask=None,
        n_artifact_combos: int | None = None,
        device="cuda",
    ):
        self.events = events
        self.grid = grid
        self.samples = samples
        self.resolution = resolution
        self.all_uniform_prior = all_uniform_prior
        self.n_samples = len(samples)
        # universe size of artifact combinations for the bias prior
        # (bias/mod.rs:131-218)
        self.n_artifact_combos = n_artifact_combos
        # [S, G] bool: per-sample grid points with nonzero prior mass
        self.valid_vaf_mask = (
            np.asarray(valid_vaf_mask, dtype=bool)
            if valid_vaf_mask is not None
            else None
        )

        # flatten branches
        self.branches = []
        for ei, ev in enumerate(events):
            for br in ev.branches:
                assert len(br.spectra) == self.n_samples, (
                    f"event {ev.name}: branch has {len(br.spectra)} spectra, "
                    f"expected {self.n_samples}"
                )
                self.branches.append((ei, br))
        self.n_branches = len(self.branches)

        G = grid.size
        NB = self.n_branches
        S = self.n_samples
        self.zero_idx = grid.index_of(0.0)

        # ---- per-sample ACTIVE subgrids (scenario per-sample resolution,
        # generic.rs:357)
        gv64 = np.round(grid.values.astype(np.float64), 10)
        self.active_idx: list[np.ndarray] = []
        for si in range(S):
            res = getattr(samples[si], "resolution", None)
            if res is None or res <= resolution * (1.0 + 1e-9):
                self.active_idx.append(np.arange(G, dtype=np.int64))
                continue
            pts = {0.0, 1.0}
            ladder = set()
            k = 0
            while k * res <= 1.0 + res * 0.5:
                pts.add(round(min(k * res, 1.0), 10))
                k += 1
            for ei, br in self.branches:
                sp = br.spectra[si]
                if sp.kind == SPECTRUM_SET:
                    pts.update(round(float(v), 10) for v in sp.values)
                else:
                    start, end = float(sp.start), float(sp.end)
                    pts.add(round(start, 10))
                    pts.add(round(end, 10))
                    # statically refine a res/3 ladder inside each end
                    # (adaptive_integration.rs:104-130)
                    for k in (1.0 / 3.0, 2.0 / 3.0):
                        for p in (start + k * res, end - k * res):
                            if start < p < end:
                                ladder.add(p)
            sel = np.zeros(G, dtype=bool)
            for v in pts:
                # snap to the NEAREST shared-grid slot
                sel[int(np.argmin(np.abs(gv64 - v)))] = True
            for v in ladder:
                sel[int(np.argmin(np.abs(gv64 - v)))] = True
            sel[self.zero_idx] = True
            self.active_idx.append(np.nonzero(sel)[0].astype(np.int64))
        self.values_s = [grid.values[idx] for idx in self.active_idx]
        self.zero_s = [
            int(np.nonzero(idx == self.zero_idx)[0][0]) for idx in self.active_idx
        ]
        self.valid_mask_s = [
            self.valid_vaf_mask[si][self.active_idx[si]]
            if self.valid_vaf_mask is not None
            else None
            for si in range(S)
        ]

        def _sub_index(si, vaf):
            vals = self.values_s[si]
            j = int(np.argmin(np.abs(vals.astype(np.float64) - vaf)))
            if abs(float(vals[j]) - vaf) > 1e-6:
                raise KeyError(
                    f"VAF {vaf} missing from sample {si} active subgrid"
                )
            return j

        self.is_range = np.zeros((NB, S), dtype=bool)
        self.rng_start = np.zeros((NB, S), dtype=np.float32)
        self.rng_end = np.zeros((NB, S), dtype=np.float32)
        self.rng_lexcl = np.zeros((NB, S), dtype=bool)
        self.rng_rexcl = np.zeros((NB, S), dtype=bool)
        self.set_mask = np.zeros((NB, S, G), dtype=bool)
        self.set_mask_s = [
            np.zeros((NB, len(self.active_idx[si])), dtype=bool)
            for si in range(S)
        ]
        self.spectrum_excludes_zero = np.zeros((NB, S), dtype=bool)
        self.spectrum_contains_zero = np.zeros((NB, S), dtype=bool)
        # static superset of each branch x sample integration support on the
        # sample's active subgrid (used only for einsum shift classes)
        support_s = [
            np.zeros((NB, len(self.active_idx[si])), dtype=bool)
            for si in range(S)
        ]
        for bi, (ei, br) in enumerate(self.branches):
            for si, sp in enumerate(br.spectra):
                sv = self.values_s[si]
                if sp.kind == SPECTRUM_SET:
                    self.set_mask[bi, si] = grid.set_mask(sp.values)
                    for v in sp.values:
                        self.set_mask_s[si][bi, _sub_index(si, v)] = True
                    # clear-ref shortcut (generic.rs:296-300): fires when
                    # every set VAF is > 0
                    self.spectrum_excludes_zero[bi, si] = all(v > 0 for v in sp.values)
                    self.spectrum_contains_zero[bi, si] = 0.0 in sp.values
                    support_s[si][bi] = self.set_mask_s[si][bi]
                else:
                    self.is_range[bi, si] = True
                    self.rng_start[bi, si] = sp.start
                    self.rng_end[bi, si] = sp.end
                    self.rng_lexcl[bi, si] = sp.left_exclusive
                    self.rng_rexcl[bi, si] = sp.right_exclusive
                    # clear-ref shortcut for ranges fires ONLY when
                    # start > 0 (generic.rs:342-347)
                    self.spectrum_excludes_zero[bi, si] = sp.start > 0
                    self.spectrum_contains_zero[bi, si] = sp.contains(0.0)
                    support_s[si][bi] = (sv >= sp.start - 1e-9) & (
                        sv <= sp.end + 1e-9
                    )
                if self.valid_mask_s[si] is not None:
                    support_s[si][bi] &= self.valid_mask_s[si]
        # per-sample spectrum-support classes for contraction shifts
        self.support_classes = []  # per sample: (class_of_branch [NB], masks [K,G])
        for si in range(S):
            keys = {}
            cls = np.zeros(NB, dtype=np.int64)
            masks = []
            for bi in range(NB):
                key = support_s[si][bi].tobytes()
                if key not in keys:
                    keys[key] = len(masks)
                    masks.append(support_s[si][bi])
                cls[bi] = keys[key]
            self.support_classes.append((cls, np.stack(masks)))

        self.branch_has_zero_point = self.spectrum_contains_zero.all(axis=1)

        self.branch_event = np.array(
            [e for (e, _) in self.branches], dtype=np.int32
        )
        self.event_is_artifact = [ev.is_artifact for ev in events]
        self.event_all_absent = [ev.all_absent() for ev in events]
        # l2fc constraints: per-branch pairwise [Ga,Gb] masks over the two
        # samples' active subgrids, canonicalised to (min, max) sample order;
        # masks on the same pair are AND-ed (utils/log2_fold_change.rs)
        self.branch_lfc_masks = {}  # bi -> list[(sample_a, sample_b, mask)]
        for bi, (ei, br) in enumerate(self.branches):
            if not br.lfcs:
                continue
            by_pair = {}
            for lfc in br.lfcs:
                va_list = self.values_s[lfc.sample_a].astype(np.float64)
                vb_list = self.values_s[lfc.sample_b].astype(np.float64)
                m = np.zeros((len(va_list), len(vb_list)), dtype=bool)
                for ia, va in enumerate(va_list):
                    for ib, vb in enumerate(vb_list):
                        m[ia, ib] = lfc.holds(va, vb)
                if lfc.sample_a <= lfc.sample_b:
                    key = (lfc.sample_a, lfc.sample_b)
                else:
                    key = (lfc.sample_b, lfc.sample_a)
                    m = np.ascontiguousarray(m.T)
                prev = by_pair.get(key)
                by_pair[key] = m if prev is None else (prev & m)
            self.branch_lfc_masks[bi] = [
                (a, b, m) for (a, b), m in by_pair.items()
            ]

        # contraction units: the contamination graph is a forest (each sample
        # has at most one contaminant parent)
        self.parent = [s.contaminated_by for s in samples]
        self.contamination_fraction = [
            float(s.contamination_fraction) if s.contaminated_by is not None
            else 0.0
            for s in samples
        ]
        comp_of = list(range(S))

        def find(x):
            while comp_of[x] != x:
                comp_of[x] = comp_of[comp_of[x]]
                x = comp_of[x]
            return x

        for si, by in enumerate(self.parent):
            if by is not None:
                comp_of[find(si)] = find(by)
        groups: dict[int, list] = {}
        for si in range(S):
            groups.setdefault(find(si), []).append(si)
        self.components = [sorted(v) for v in groups.values()]
        self._derive()
        self._to_device(device)

    # ------------------------------------------------------------------
    def _derive(self):
        """Tables derived from the setup state (shared by __init__ and
        :meth:`from_state`)."""
        S = self.n_samples
        self.n_events = len(self.event_is_artifact)
        self.event_branch_idx = [
            [bi for bi in range(self.n_branches) if self.branch_event[bi] == ei]
            for ei in range(self.n_events)
        ]
        self.pairs = [
            (si, self.parent[si], self.contamination_fraction[si])
            for si in range(S)
            if self.parent[si] is not None
        ]
        # unique (nu, kappa) gather classes per contaminated sample, on the
        # (child, parent) active subgrids
        if not hasattr(self, "pair_class"):
            self.pair_class = {
                si: _pair_class_setup(self.values_s[si], self.values_s[by], frac)
                for si, by, frac in self.pairs
            }
        self.root_samples = [si for si in range(S) if self.parent[si] is None]
        # each sample's component, an index into self.components
        self._comp_of = [
            next(c for c, comp in enumerate(self.components) if si in comp)
            for si in range(S)
        ]
        self.singletons = [c[0] for c in self.components if len(c) == 1]

    def state(self) -> dict:
        """The engine's setup tables as numpy arrays (see ``convert.py``)."""
        from ..convert import engine_state

        return engine_state(self)

    @classmethod
    def from_state(cls, state: dict, device="cuda"):
        """Build an engine from :meth:`state` / ``convert.engine_state_from_jax``
        tables.  The result evaluates batches; it holds no event objects, so
        callers that gate branches by SNV keys construct from events."""
        self = cls.__new__(cls)
        S = int(state["n_samples"])
        self.events = None
        self.branches = None
        self.samples = None
        self.grid = AFGrid(values=np.asarray(state["grid_values"]))
        self.resolution = float(state["resolution"])
        self.all_uniform_prior = bool(state["all_uniform_prior"])
        nac = int(state["n_artifact_combos"])
        self.n_artifact_combos = None if nac < 0 else nac
        self.n_samples = S
        self.zero_idx = int(state["zero_idx"])
        self.valid_vaf_mask = state.get("valid_vaf_mask")
        self.active_idx = [state[f"active_idx/{si}"] for si in range(S)]
        self.values_s = [state[f"values_s/{si}"] for si in range(S)]
        self.zero_s = [int(z) for z in state["zero_s"]]
        self.valid_mask_s = [state.get(f"valid_mask_s/{si}") for si in range(S)]
        for k in ("is_range", "rng_start", "rng_end", "rng_lexcl", "rng_rexcl",
                  "set_mask", "spectrum_excludes_zero", "spectrum_contains_zero",
                  "branch_has_zero_point", "branch_event"):
            setattr(self, k, state[k])
        self.set_mask_s = [state[f"set_mask_s/{si}"] for si in range(S)]
        self.support_classes = [
            (state[f"support_classes/{si}/branch_class"],
             state[f"support_classes/{si}/masks"])
            for si in range(S)
        ]
        self.n_branches = len(self.branch_event)
        self.event_is_artifact = [bool(x) for x in state["event_is_artifact"]]
        self.event_all_absent = [bool(x) for x in state["event_all_absent"]]
        lfc = {}
        for k in state:
            if k.startswith("branch_lfc_masks/") and k.endswith("/mask"):
                _, bi, j, _ = k.split("/")
                pre = k[: -len("mask")]
                lfc.setdefault(int(bi), {})[int(j)] = (
                    int(state[pre + "a"]), int(state[pre + "b"]), state[k],
                )
        self.branch_lfc_masks = {
            bi: [per[j] for j in sorted(per)] for bi, per in sorted(lfc.items())
        }
        self.parent = [None if p < 0 else int(p) for p in state["parent"]]
        self.contamination_fraction = [
            float(f) for f in state["contamination_fraction"]
        ]
        comp = state["component_of"]
        self.components = [
            [si for si in range(S) if comp[si] == k]
            for k in range(int(comp.max()) + 1)
        ]
        self.pair_class = {
            si: (state[f"pair_class/{si}/nu_u"], state[f"pair_class/{si}/kappa_u"],
                 state[f"pair_class/{si}/inv"])
            for si in range(S)
            if self.parent[si] is not None
        }
        self._derive()
        self._to_device(device)
        return self

    def _to_device(self, device):
        """Constant tables as tensors on the engine's device."""
        dev = self.device = resolve_device(device)
        # steps taken by the grid-axis loops (star l2fc, l2fc enumeration,
        # contamination cycles, --full-prior trio / generic), for the
        # launch accounting of chip_smoke.py
        self.loop_steps = 0
        # the l2fc integrals' [cells, bytes] of the current pass, and the
        # traced passes' (counter, start, end) stream marks not yet handed
        # to a pending fetch
        self._lfc_work = [0, 0]
        self._stream_marks = []
        # traced: (counter, device tensor) counts that the pending fetch
        # copies to the host with the run's outputs
        self._device_counts = []

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)

        S = self.n_samples
        self._values_t = [t(v, torch.float32) for v in self.values_s]
        self._set_mask_t = [t(m) for m in self.set_mask_s]
        self._valid_mask_t = [
            t(m) if m is not None else None for m in self.valid_mask_s
        ]
        self._rng = {
            k: t(getattr(self, k))
            for k in ("rng_start", "rng_end", "rng_lexcl", "rng_rexcl", "is_range")
        }
        self._excl0 = t(self.spectrum_excludes_zero)
        self._z0 = t(self.branch_has_zero_point)
        self._assemble_t = AssembleTables(
            self.event_branch_idx, self.event_is_artifact, self.branch_event,
            self._values_t, [self._afd_backbone(si) for si in range(S)],
            AFD_TOP_K, dev,
        )
        self._pair_t = {
            si: (t(nu, torch.float32), t(kap, torch.float32),
                 t(inv.astype(np.int64)))
            for si, (nu, kap, inv) in self.pair_class.items()
        }
        self._support_t = [
            class_table(cls, masks, dev) for cls, masks in self.support_classes
        ]
        # l2fc masks as log masks (0 / -inf): per branch, and per sample
        # pair stacked over branches [NB, Ga, Gb] for --full-prior
        self._lfc_t = {
            bi: [(a, b, t(_log_mask(m))) for a, b, m in lst]
            for bi, lst in self.branch_lfc_masks.items()
        }
        by_pair = {}
        for bi, lst in self.branch_lfc_masks.items():
            for a, b, m in lst:
                if (a, b) not in by_pair:
                    by_pair[(a, b)] = np.zeros(
                        (self.n_branches,) + m.shape, dtype=np.float32
                    )
                by_pair[(a, b)][bi] += _log_mask(m)
        self._lfc_by_pair_t = {k: t(v) for k, v in by_pair.items()}

    # ------------------------------------------------------------------
    def _weights_list(self, n_obs):
        """Per-sample [L, NB, G_i] log integration weights on the active
        subgrid (trapezoid widths taken on the subgrid lattice)."""
        out = []
        rng = self._rng
        for si in range(self.n_samples):
            vals = self._values_t[si]
            n = n_obs[:, si][:, None]  # [L,1]
            start = rng["rng_start"][:, si][None]  # [1,NB]
            end = rng["rng_end"][:, si][None]
            lex = rng["rng_lexcl"][:, si][None]
            rex = rng["rng_rexcl"][:, si][None]
            shape = torch.broadcast_shapes(n.shape, start.shape)
            rw = range_weights(
                vals,
                start.expand(shape),
                end.expand(shape),
                lex.expand(shape),
                rex.expand(shape),
                n.expand(shape),
            )  # [L,NB,Gi]
            setw = torch.where(self._set_mask_t[si][None], 0.0, NEG_INF)
            w = torch.where(rng["is_range"][:, si][None, :, None], rw, setw)
            if self._valid_mask_t[si] is not None:
                w = w + torch.where(self._valid_mask_t[si][None, None], 0.0, NEG_INF)
            out.append(w)
        return out

    # ------------------------------------------------------------------
    def _lse_contract(self, F, S, classes):
        """logsumexp over v of F[l,b,v,u] + S[l,b,n,v] -> [l,b,n,u], with
        shifts per spectrum-support class of the eliminated sample
        (``ops/lse_contract.py``; classes: its ``ClassTable``)."""
        return lse_contract(F, S, classes)

    def _component_cycle(self, comp):
        """Cycle nodes of a component in parent order, or []."""
        compset = set(comp)
        seen = {}
        p = comp[0]
        while p is not None and p in compset:
            if p in seen:
                cyc = [p]
                q = self.parent[p]
                while q != p:
                    cyc.append(q)
                    q = self.parent[q]
                return cyc
            seen[p] = True
            p = self.parent[p]
        return []

    def _component_reduce(self, comp, loglik, pair_logliks, w_list, keep=None):
        """Tree variable elimination over a component's grid axes.

        loglik {si: [L,B,G_i]} (own-likelihoods of root samples);
        pair_logliks {si: [L,B,G_i,G_parent]}; w_list [si] = [L,NB,G_i].
        Returns [L,B,NB] (keep=None) or [L,B,NB,G_keep]."""
        from collections import deque

        cyc = self._component_cycle(comp)
        if len(cyc) >= 3:
            return self._component_reduce_cyclic(
                comp, cyc, loglik, pair_logliks, w_list, keep
            )
        NB = self.n_branches
        adj = {si: set() for si in comp}
        for si in comp:
            p = self.parent[si]
            if p is not None and p in adj:
                adj[si].add(p)
                adj[p].add(si)
        root = keep if keep is not None else comp[0]
        depth = {root: 0}
        dq = deque([root])
        while dq:
            u0 = dq.popleft()
            for v2 in adj[u0]:
                if v2 not in depth:
                    depth[v2] = depth[u0] + 1
                    dq.append(v2)
        order = sorted(comp, key=lambda s: -depth[s])

        # per-node 1-var parts: start with weights (+ own loglik for roots)
        parts = {}
        for si in comp:
            p_list = [w_list[si][:, None]]  # [L,1,NB,Gi]
            if self.parent[si] is None:
                p_list.append(loglik[si][:, :, None, :])  # [L,B,1,Gi]
            parts[si] = p_list
        # 2-var factors: (child, parent) -> F [L,B,Gchild,Gparent]
        edge_factors = {}
        for si in comp:
            p = self.parent[si]
            if p is not None and p in adj:
                edge_factors.setdefault(frozenset((si, p)), []).append(
                    (si, p, pair_logliks[si])
                )

        for v in order:
            if keep is not None and v == keep:
                continue
            nbrs = [u for u in adj[v] if frozenset((v, u)) in edge_factors]
            if not nbrs:
                continue  # singleton root handled at the end
            assert len(nbrs) == 1, "contamination graph is not a tree"
            u = nbrs[0]
            Fs = None
            for child, par, t in edge_factors.pop(frozenset((v, u))):
                tt = t if child == v else torch.swapaxes(t, -1, -2)
                Fs = tt if Fs is None else Fs + tt  # mutual 2-cycle sums both
            S_v = None
            for p_ in parts.pop(v):
                S_v = p_ if S_v is None else S_v + p_
            S_v = S_v.expand(S_v.shape[0], Fs.shape[1], NB, S_v.shape[-1])
            msg = self._lse_contract(Fs, S_v, self._support_t[v])
            parts[u].append(msg)
            adj[u].discard(v)

        out = None
        for p_ in parts[root]:
            out = p_ if out is None else out + p_
        B = max(
            (t.shape[1] for t in loglik.values()),
            default=next(iter(pair_logliks.values())).shape[1]
            if pair_logliks
            else 1,
        )
        out = out.expand(out.shape[0], B, NB, out.shape[-1])
        if keep is not None:
            return out
        return _lse(out, dim=-1)

    def _component_reduce_cyclic(
        self, comp, cyc, loglik, pair_logliks, w_list, keep=None
    ):
        """Variable elimination for a rho-shaped component (one
        contamination cycle of length >= 3 with trees hanging off it).

        Tree nodes are eliminated into their parents first; the cycle is
        then contracted into its base node with a two-axis frontier
        [L,B,NB,G_i] per base grid point (the reference's [L,B,NB,G_i,
        G_base] frontier, one g_base slice per loop step, each reduced by
        direct logsumexp); last the keep->cycle path is walked back down."""
        NB = self.n_branches
        B = next(iter(pair_logliks.values())).shape[1]
        cycset = set(cyc)

        parts = {si: [w_list[si][:, None]] for si in comp}
        for si in comp:
            if self.parent[si] is None:
                parts[si].append(loglik[si][:, :, None, :])

        # attachment/base node on the cycle + the keep->cycle path
        if keep is None or keep in cycset:
            base = keep if keep is not None else cyc[0]
            path = []
        else:
            path = [keep]
            p = self.parent[keep]
            while p not in cycset:
                path.append(p)
                p = self.parent[p]
            base = p
        path_set = set(path)

        def S_of(v):
            s = None
            for p_ in parts.pop(v):
                s = p_ if s is None else s + p_
            return s.expand(s.shape[0], B, NB, s.shape[-1])

        # 1) eliminate pure tree nodes into their parents, deepest first
        def dist_to_cycle(v):
            d, p = 0, v
            while p not in cycset:
                p = self.parent[p]
                d += 1
            return d

        tree_nodes = [v for v in comp if v not in cycset and v not in path_set]
        for v in sorted(tree_nodes, key=lambda v: -dist_to_cycle(v)):
            u = self.parent[v]
            msg = self._lse_contract(pair_logliks[v], S_of(v), self._support_t[v])
            parts[u].append(msg)

        # 2) contract the cycle into base (keeping g_base)
        i0 = cyc.index(base)
        order = cyc[i0:] + cyc[:i0]  # order[0]=base, parent(order[i])=order[i+1]
        k = len(order)
        S_cyc = [None] + [S_of(order[i]) for i in range(1, k)]
        F0 = pair_logliks[order[0]]  # [L,B,G_base,G_b1]
        Fk = pair_logliks[order[-1]]  # [L,B,G_bk-1,G_base]
        cols = []
        for gb in range(F0.shape[2]):
            self.loop_steps += 1
            T = F0[:, :, gb][:, :, None] + S_cyc[1]  # [L,B,NB,G_b1]
            for i in range(1, k - 1):
                Fi = pair_logliks[order[i]]  # [L,B,G_bi,G_bi+1]
                T = _lse(T[..., :, None] + Fi[:, :, None], dim=-2)
                T = T + S_cyc[i + 1]  # [L,B,NB,G_bi+1]
            cols.append(_lse(T + Fk[:, :, None, :, gb], dim=-1))  # [L,B,NB]
        parts[base].append(torch.stack(cols, dim=-1))  # [L,B,NB,G_base]

        # 3) walk the keep path: eliminate base down toward keep
        cur = base
        for v in reversed(path):
            F = torch.swapaxes(pair_logliks[v], -1, -2)  # [L,B,G_cur,G_v]
            msg = self._lse_contract(F, S_of(cur), self._support_t[cur])
            parts[v].append(msg)
            cur = v

        out = None
        for p_ in parts[cur]:
            out = p_ if out is None else out + p_
        out = out.expand(out.shape[0], B, NB, out.shape[-1])
        if keep is not None:
            return out
        return _lse(out, dim=-1)

    def _lfc_group_joint(
        self, constraints, nodes, loglik, pair_logliks, w_list, bi,
        comp_of_sample,
    ):
        """Generic l2fc contraction: jointly enumerate the union of the
        contamination components touched by a constraint cluster under all
        its pairwise log masks (cyclic constraint graphs, chains over
        contaminated samples, any contamination topology).  A loop over the
        flattened grid product of all but the two largest axes keeps one
        [L,B,Gx,Gy] slab per step.  Returns ([L,B] integral, [L,B]
        all-zero-point value)."""
        import itertools

        union = sorted({s for n in nodes for s in comp_of_sample[n]})
        joint_cells = int(
            np.prod([len(self.values_s[s]) for s in union])
        )
        if joint_cells > 2_000_000:
            raise ValueError(
                f"l2fc constraint cluster spans a joint grid of "
                f"{joint_cells} cells over samples {union}; coarsen "
                "per-sample `resolution:` in the scenario"
            )
        L = w_list[0].shape[0]
        B = (
            next(iter(pair_logliks.values())).shape[1]
            if pair_logliks
            else next(iter(loglik.values())).shape[1]
        )
        d = {}
        for s in union:
            ds = w_list[s][:, bi][:, None, :]  # [L,1,Gs]
            if self.parent[s] is None:
                ds = ds + loglik[s]
            d[s] = ds.expand(L, B, ds.shape[-1])
        factors = []  # (x, y, tensor broadcastable to [L,B,Gx,Gy])
        for s in union:
            p = self.parent[s]
            if p is not None:
                factors.append((s, p, pair_logliks[s]))
        for a, b, lm in constraints:
            factors.append((a, b, lm[None, None]))
        self._lfc_count(
            L * B * joint_cells,
            sum(L * B * d[s].shape[-1] for s in union)
            + sum(f.numel() for _, _, f in factors),
            L * B,
        )

        z = torch.zeros((L, B), device=w_list[0].device)
        for s in union:
            z = z + d[s][..., self.zero_s[s]]
        for x2, y2, Fxy in factors:
            z = z + Fxy[..., self.zero_s[x2], self.zero_s[y2]]

        order = sorted(union, key=lambda s: d[s].shape[-1])
        x, y = order[-2], order[-1]
        lead = order[:-2]
        slab_base = d[x][:, :, :, None] + d[y][:, :, None, :]
        lead_factors = []
        for a2, b2, Fab in factors:
            if {a2, b2} <= {x, y}:
                t = Fab if (a2, b2) == (x, y) else torch.swapaxes(Fab, -1, -2)
                slab_base = slab_base + t
            else:
                lead_factors.append((a2, b2, Fab))
        if not lead:
            return _lse(slab_base, dim=(-2, -1)), z

        lead_pos = {s: i for i, s in enumerate(lead)}
        total = torch.full((L, B), NEG_INF, device=z.device)
        for coords in itertools.product(*(range(d[s].shape[-1]) for s in lead)):
            self.loop_steps += 1
            slab = slab_base
            for s in lead:
                slab = slab + d[s][..., coords[lead_pos[s]]][:, :, None, None]
            for a2, b2, Fab in lead_factors:
                if a2 in lead_pos and b2 in lead_pos:
                    v = Fab[:, :, coords[lead_pos[a2]], coords[lead_pos[b2]]]
                    slab = slab + v[:, :, None, None]
                elif a2 in lead_pos:
                    v = Fab[:, :, coords[lead_pos[a2]]]  # [.,.,Gb]
                    slab = slab + (
                        v[:, :, :, None] if b2 == x else v[:, :, None, :]
                    )
                else:
                    v = Fab[:, :, :, coords[lead_pos[b2]]]  # [.,.,Ga]
                    slab = slab + (
                        v[:, :, :, None] if a2 == x else v[:, :, None, :]
                    )
            total = torch.logaddexp(total, _lse(slab, dim=(-2, -1)))
        return total, z

    def _lfc_tree_eliminate(self, group, nodes, loglik, w_list, bi):
        """Chained l2fc over singleton samples: eliminate the acyclic
        constraint graph leaf-to-root with pairwise log-mask contractions.
        Returns ([L,B] integral, [L,B] all-zero-point value)."""
        from collections import deque

        adj = {s: [] for s in nodes}
        for a, b, lm in group:
            adj[a].append((b, lm, True))  # mask oriented (a, b)
            adj[b].append((a, lm, False))
        root = nodes[0]
        depth = {root: 0}
        dq = deque([root])
        while dq:
            u = dq.popleft()
            for v, _, _ in adj[u]:
                if v not in depth:
                    depth[v] = depth[u] + 1
                    dq.append(v)
        d = {
            s: loglik[s] + w_list[s][:, bi][:, None, :]  # [L,B,Gs]
            for s in nodes
        }
        L, B = d[root].shape[0], d[root].shape[1]
        self._lfc_count(
            sum(L * B * lm.numel() for _, _, lm in group),
            sum(L * B * d[s].shape[-1] for s in nodes)
            + sum(lm.numel() for _, _, lm in group),
            L * B,
        )
        z = None
        for s in nodes:
            zv = d[s][:, :, self.zero_s[s]]
            z = zv if z is None else z + zv
        for a, b, lm in group:
            z = z + lm[self.zero_s[a], self.zero_s[b]]
        done = set()
        for v in sorted(nodes, key=lambda s: -depth[s]):
            if v == root:
                continue
            # unique parent = the neighbour closer to the root
            for u, lm, oriented_vu in adj[v]:
                if depth[u] == depth[v] - 1 and (v, u) not in done:
                    lmo = lm if oriented_vu else lm.T
                    # lse over v's axis against the mask -> message to u
                    d[u] = d[u] + _lse(d[v][:, :, :, None] + lmo[None, None], dim=2)
                    done.add((v, u))
                    break
        return _lse(d[root], dim=-1), z

    def _lfc_count(self, cells, inputs, outputs):
        """Add one l2fc integral's work to the pass's count: its joint grid
        cells, and the bytes of its float32 inputs read once (``inputs``
        elements) and of its two [L,B] outputs written once (``outputs``
        elements each)."""
        self._lfc_work[0] += cells
        self._lfc_work[1] += 4 * (inputs + 2 * outputs)

    def _lfc_terms(self, T, Z, U, Uzero, loglik, pair_logliks, w_list):
        """:meth:`_lfc_branches` in the span ``engine.lfc``.  Traced, it
        counts ``engine.lfc_steps`` (the plain grid-axis loops' steps: none
        where the star route's kernel runs, which counts its launches in
        ``engine.lfc_star_launches``),
        ``engine.lfc_cells`` and ``engine.lfc_bytes`` (the integrals' joint
        grid cells and bytes, :meth:`_lfc_count`), and marks the stream at
        its start and end: the marks go with the run's pending fetch, whose
        :meth:`fetch_run` counts the stream time between them as
        ``engine.lfc_stream_ns``."""
        with tracing.span("engine.lfc"):
            traced = tracing.enabled()
            if traced:
                start, steps0 = _stream_mark(T.device), self.loop_steps
            self._lfc_work = [0, 0]
            T, Z = self._lfc_branches(T, Z, U, Uzero, loglik, pair_logliks, w_list)
            if traced:
                self._stream_marks.append(
                    ("engine.lfc_stream_ns", start, _stream_mark(T.device))
                )
                tracing.count("engine.lfc_steps", self.loop_steps - steps0)
                tracing.count("engine.lfc_cells", self._lfc_work[0])
                tracing.count("engine.lfc_bytes", self._lfc_work[1])
        return T, Z

    def _lfc_branches(self, T, Z, U, Uzero, loglik, pair_logliks, w_list):
        """Branches with l2fc constraints: re-contract the constrained
        samples jointly under their pairwise log masks.  T, Z [L,B,NB]
        (updated in place on the constrained branches)."""
        L, B = T.shape[0], T.shape[1]
        dev = T.device
        comp_of_sample = {}
        for comp in self.components:
            for s in comp:
                comp_of_sample[s] = tuple(comp)
        for bi, lfc_list in self._lfc_t.items():
            coupled = {s for (a, b, _) in lfc_list for s in (a, b)}
            coupled_comps = {comp_of_sample[s] for s in coupled}
            t_bi = torch.zeros((L, B), device=dev)
            z_bi = torch.zeros((L, B), device=dev)
            for key, val in U.items():
                if tuple(key[1:]) in coupled_comps:
                    continue
                t_bi = t_bi + val[:, :, bi]
                z_bi = z_bi + Uzero[key][:, :, bi]
            # constraint graph components; groups that touch the same
            # contamination component merge into one cluster (their
            # integrals share grid axes and may be counted only once)
            lfc_groups = [list(g) for g in _lfc_components(lfc_list)]

            def comps_of(group):
                return {
                    comp_of_sample[s]
                    for (a, b, _) in group
                    for s in (a, b)
                    if len(comp_of_sample[s]) > 1
                }

            merged = True
            while merged:
                merged = False
                for i in range(len(lfc_groups)):
                    ci = comps_of(lfc_groups[i])
                    for j in range(i + 1, len(lfc_groups)):
                        if ci & comps_of(lfc_groups[j]):
                            lfc_groups[i].extend(lfc_groups.pop(j))
                            merged = True
                            break
                    if merged:
                        break
            for group in lfc_groups:
                t_c, z_c = self._lfc_group_term(
                    group, loglik, pair_logliks, w_list, bi, comp_of_sample
                )
                t_bi = t_bi + t_c
                z_bi = z_bi + z_c
            T[:, :, bi] = t_bi
            Z[:, :, bi] = z_bi
        return T, Z

    def _lfc_group_term(self, group, loglik, pair_logliks, w_list, bi,
                        comp_of_sample):
        """([L,B] integral, [L,B] all-zero-point value) of one constraint
        cluster of branch bi."""
        nodes = sorted({s for (a, b, _) in group for s in (a, b)})
        if len(group) > 1:
            acyclic = len(group) == len(nodes) - 1
            if acyclic and all(s in self.singletons for s in nodes):
                return self._lfc_tree_eliminate(group, nodes, loglik, w_list, bi)
            # cyclic graphs / chains over contaminated samples
            return self._lfc_group_joint(
                group, nodes, loglik, pair_logliks, w_list, bi, comp_of_sample
            )
        a, b, lm = group[0]
        za, zb = self.zero_s[a], self.zero_s[b]
        if a in self.singletons and b in self.singletons:
            da = loglik[a] + w_list[a][:, bi][:, None, :]  # [L,B,Ga]
            db = loglik[b] + w_list[b][:, bi][:, None, :]
            joint_ab = da[:, :, :, None] + db[:, :, None, :] + lm[None, None]
            self._lfc_count(joint_ab.numel(), da.numel() + db.numel() + lm.numel(),
                            da.shape[0] * da.shape[1])
            z00 = da[:, :, za] + db[:, :, zb] + lm[za, zb]
            return _lse(joint_ab, dim=(-2, -1)), z00
        # both contaminated by the same root parent (star component, e.g.
        # tumor and relapse both contaminated by normal): lse over
        # (ga, gb, gp), ops/lfc_star.py (on the card one kernel launch; on
        # the CPU a loop over the parent grid, one [L,B,Ga,Gb] slab a step)
        p = self.parent[a]
        if (
            p is None
            or self.parent[b] != p
            or self.parent[p] is not None
            or comp_of_sample[a] != comp_of_sample[b]
        ):
            # any other shape (l2fc against one's own contaminant, deeper
            # chains, ...): generic joint enumeration
            return self._lfc_group_joint(
                group, nodes, loglik, pair_logliks, w_list, bi, comp_of_sample
            )
        zp = self.zero_s[p]
        pa, pb = pair_logliks[a], pair_logliks[b]  # [L,B,Ga,Gp], [L,B,Gb,Gp]
        wa, wb = w_list[a][:, bi], w_list[b][:, bi]  # [L,Ga], [L,Gb]
        rp = loglik[p] + w_list[p][:, bi][:, None, :]  # [L,B,Gp]
        L, B = rp.shape[0], rp.shape[1]
        cells = L * B * lm.numel() * rp.shape[-1]  # the (a, b, p) joint grid
        inputs = pa.numel() + pb.numel() + rp.numel() + lm.numel()
        rp_zero = rp[..., zp]
        for c in comp_of_sample[a]:
            if c in (a, b, p):
                continue
            fc = pair_logliks[c] + w_list[c][:, bi][:, None, :, None]
            cells, inputs = cells + fc.numel(), inputs + fc.numel()
            rp = rp + _lse(fc, dim=-2)
            rp_zero = rp_zero + fc[..., self.zero_s[c], zp]
        self._lfc_count(cells, inputs, L * B)
        total = lfc_star(pa, wa, pb, wb, lm, rp)
        if rp.device.type == "cpu":  # the plain version's loop steps
            self.loop_steps += rp.shape[-1]
        fa_z = pa[..., za, zp] + wa[:, None, za]  # fa[..., za, zp]
        fb_z = pb[..., zb, zp] + wb[:, None, zb]
        z00 = fa_z + fb_z + lm[za, zb] + rp_zero
        return total, z00

    def _full_prior_terms(self, P, idx, loglik, pair_logliks, w_list, branch_gates,
                          combo_active):
        """:meth:`_full_prior_T` in the span ``engine.full_prior``.  Traced,
        it counts ``engine.full_prior_steps`` (the grid-axis loops' steps),
        ``engine.full_prior_cells`` (for every locus, active combination and
        open branch, the product over samples of the branch's grid points
        with a finite weight: the joint cells any exact method must touch),
        ``engine.full_prior_bytes`` (the float32 likelihoods and weights
        read once, the table once, the per-locus index, the [L,B,NB] output
        written once), and marks the stream at its start and end, as
        :meth:`_lfc_terms` does (``engine.full_prior_stream_ns``)."""
        with tracing.span("engine.full_prior"):
            traced = tracing.enabled()
            if traced:
                dev = P.device
                start, steps0 = _stream_mark(dev), self.loop_steps
            B = combo_active.shape[1]
            T = self._full_prior_T(P, idx, loglik, pair_logliks, w_list, B)
            if traced:
                self._stream_marks.append(
                    ("engine.full_prior_stream_ns", start, _stream_mark(dev))
                )
                tracing.count("engine.full_prior_steps", self.loop_steps - steps0)
                per_branch = None
                for w in w_list:  # [L,NB,Gs]
                    n = torch.isfinite(w).sum(dim=-1)
                    per_branch = n if per_branch is None else per_branch * n
                per_branch = per_branch * branch_gates
                cells = (per_branch.sum(dim=1) * combo_active.sum(dim=1)).sum()
                self._device_counts.append(("engine.full_prior_cells", cells))
                L, NB = T.shape[0], T.shape[2]
                read = sum(w.numel() for w in w_list)
                read += sum(v.numel() for v in loglik.values())
                read += sum(v.numel() for v in pair_logliks.values())
                tracing.count("engine.full_prior_bytes",
                              4 * (read + P.numel() + L + L * B * NB))
        return T

    def _full_prior_T(self, P, idx, loglik, pair_logliks, w_list, B):
        """[L,B,NB] branch values under the joint prior table ``P`` ([K] +
        the per-sample active subgrid sizes; --full-prior) at each locus's
        row ``idx`` [L], with the l2fc masks folded in (prior.rs:298-438
        with is_absent_only = false)."""
        import itertools

        S = self.n_samples
        lfc_by_pair = self._lfc_by_pair_t

        if S == 1:
            d0 = loglik[0][:, :, None, :] + w_list[0][:, None]  # [L,B,NB,G0]
            return _lse(d0 + P[idx][:, None, None, :], dim=-1)
        if S == 2 and self.pairs:
            si, by, _ = self.pairs[0]
            pl = pair_logliks[si]  # [L,B,Gc,Gp]
            wp = w_list[si][:, None, :, :, None]  # [L,1,NB,Gc,1]
            wc = w_list[by][:, None, :, None, :]  # [L,1,NB,1,Gp]
            if self.parent[by] is not None:
                # mutual contamination (2-cycle): both samples carry a
                # two-axis pair likelihood; neither has an own-axis term
                pl = pl + torch.swapaxes(pair_logliks[by], -1, -2)
                joint = pl[:, :, None] + wp + wc
            else:
                joint = pl[:, :, None] + wp + wc + loglik[by][:, :, None, None, :]
            Pl = P[idx]
            Po = Pl if si < by else torch.swapaxes(Pl, -1, -2)
            joint = joint + Po[:, None, None]
            # joint axes are (si, by); masks are stored as (0, 1)
            for (a, b), M in lfc_by_pair.items():
                Mo = M if (a, b) == (si, by) else torch.swapaxes(M, -1, -2)
                joint = joint + Mo[None, None]
            return _lse(joint, dim=(-2, -1))
        if S == 2:
            d0 = loglik[0][:, :, None, :] + w_list[0][:, None]
            d1 = loglik[1][:, :, None, :] + w_list[1][:, None]
            joint = d0[..., :, None] + d1[..., None, :] + P[idx][:, None, None]
            for M in lfc_by_pair.values():  # canonical (0, 1)
                joint = joint + M[None, None]
            return _lse(joint, dim=(-2, -1))
        L = w_list[0].shape[0]
        NB = self.n_branches
        if S == 3 and not self.pairs:
            d = [loglik[s][:, :, None, :] + w_list[s][:, None] for s in range(3)]
            # trio (mendelian): a loop over the first sample's grid axis,
            # one [Lc,B,NB,G1,G2] slab per step, over chunks of Lc loci
            # that keep a slab within _FULL_PRIOR_SLAB_BYTES
            G1, G2 = d[1].shape[-1], d[2].shape[-1]
            Lc = max(1, _FULL_PRIOR_SLAB_BYTES // (4 * B * NB * G1 * G2))
            parts = []
            for l0 in range(0, L, Lc):
                sl = slice(l0, min(L, l0 + Lc))
                parts.append(self._trio_chunk(P, idx[sl], [x[sl] for x in d]))
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        # any S and any contamination digraph (cycles included): enumerate
        # the joint subgrid product with a loop over the flattened leading
        # S-2 axes, one [L,B,NB,G_{S-2},G_{S-1}] slab per step
        x_s, y_s = S - 2, S - 1
        contaminated = {si for si, _by, _f in self.pairs}
        # single-axis factors: the branch weight per sample, plus the own
        # likelihood of samples without a contaminant factor
        singles = []  # (axis, [L,{1|B},NB,Gs])
        for s in range(S):
            w = w_list[s][:, None]
            if s not in contaminated:
                w = loglik[s][:, :, None, :] + w
            singles.append((s, w))
        # two-axis contaminant factors, one per contaminated sample (a
        # mutual 2-cycle contributes both orientations)
        pair_fs = [
            (si, by, pair_logliks[si][:, :, None])  # [L,B,1,Gsi,Gby]
            for si, by, _f in self.pairs
        ]
        T = torch.full((L, B, NB), NEG_INF, device=P.device)
        lead_sizes = [len(self.values_s[s]) for s in range(S - 2)]
        for c in itertools.product(*(range(n) for n in lead_sizes)):
            self.loop_steps += 1
            slab = P[(slice(None),) + c][idx][:, None, None]  # [L,1,1,Gx,Gy]
            for s, arr in singles:
                if s < x_s:
                    slab = slab + arr[..., c[s]][..., None, None]
                elif s == x_s:
                    slab = slab + arr[..., :, None]
                else:
                    slab = slab + arr[..., None, :]
            for si, by, arr in pair_fs:
                if si < x_s and by < x_s:
                    slab = slab + arr[..., c[si], c[by]][..., None, None]
                elif si < x_s:  # by on a tail axis
                    row = arr[..., c[si], :]  # [L,B,1,Gby]
                    slab = slab + (
                        row[..., :, None] if by == x_s else row[..., None, :]
                    )
                elif by < x_s:  # si on a tail axis
                    col = arr[..., c[by]]  # [L,B,1,Gsi]
                    slab = slab + (
                        col[..., :, None] if si == x_s else col[..., None, :]
                    )
                else:  # both tail axes
                    slab = slab + (
                        arr if (si, by) == (x_s, y_s) else torch.swapaxes(arr, -1, -2)
                    )
            for (a3, b3), M in lfc_by_pair.items():
                if (a3, b3) == (x_s, y_s):
                    slab = slab + M[None, None]
                elif b3 < x_s:  # both on lead axes
                    slab = slab + M[:, c[a3], c[b3]][None, None, :, None, None]
                else:  # a3 on a lead axis, b3 on a tail axis (a3 < b3)
                    row = M[:, c[a3]]  # [NB, Gb]
                    slab = slab + (
                        row[None, None, :, :, None]
                        if b3 == x_s
                        else row[None, None, :, None, :]
                    )
            T = torch.logaddexp(T, _lse(slab, dim=(-2, -1)))
        return T

    def _trio_chunk(self, P, idx, d):
        """The trio loop of :meth:`_full_prior_T` on one chunk of loci:
        ``d`` the three samples' [Lc,B,NB,Gs] terms, ``idx`` the chunk's
        table rows.  Each step adds the prior's [Lc,G1,G2] plane at one point
        of the first sample's grid to the [Lc,B,NB,G1,G2] slab of the other
        two and reduces it in place (the steps of ``_lse``)."""
        lfc_by_pair = self._lfc_by_pair_t
        d0, d1, d2 = d
        base = d1[..., :, None] + d2[..., None, :]
        M12 = lfc_by_pair.get((1, 2))
        if M12 is not None:
            base = base + M12[None, None]
        T = torch.full(base.shape[:3], NEG_INF, device=base.device)
        for g0 in range(d0.shape[-1]):
            self.loop_steps += 1
            plane = P[:, g0][idx]  # [Lc,G1,G2]
            slab = base + plane[:, None, None]
            for (a, b), M in lfc_by_pair.items():
                if a != 0:
                    continue
                row = M[:, g0]  # [NB, G_b]
                slab.add_(
                    row[None, None, :, :, None]
                    if b == 1
                    else row[None, None, :, None, :]
                )
            m = torch.amax(slab, dim=(-2, -1), keepdim=True)
            fin = torch.isfinite(m)
            m_safe = torch.where(fin, m, 0.0)
            ssum = slab.sub_(m_safe).exp_().sum(dim=(-2, -1), keepdim=True)
            step = torch.where(fin, torch.log(ssum) + m_safe, m).squeeze(-1).squeeze(-1)
            T = torch.logaddexp(T, step + d0[..., g0])
        return T

    def _unit_terms(self, loglik, pair_logliks, w_list, B):
        """Per-unit branch integrals: U[unit] and Uzero[unit] (the unit's
        value at the all-zero point), each [L,B,NB]."""
        U = {}
        Uzero = {}
        NB = self.n_branches
        for comp in self.components:
            key = ("c",) + tuple(comp)
            U[key] = self._component_reduce(comp, loglik, pair_logliks, w_list)
            zval = None
            for si in comp:
                zi = self.zero_s[si]
                tz = w_list[si][:, :, zi][:, None]  # [L,1,NB]
                if self.parent[si] is None:
                    tz = tz + loglik[si][:, :, zi][:, :, None]
                else:
                    zp = self.zero_s[self.parent[si]]
                    tz = tz + pair_logliks[si][:, :, zi, zp][:, :, None]
                zval = tz if zval is None else zval + tz
            Uzero[key] = zval.expand(zval.shape[0], B, NB)
        return U, Uzero

    def _pair_logliks(self, feats, mask, bias_alt, bias_ref, bias_any):
        """[L,B,Gc,Gp] contaminated likelihoods via the unique (nu, kappa)
        class gather."""
        out = {}
        for si, by, frac in self.pairs:
            nu_u, kappa_u, inv = self._pair_t[si]
            ll_u = _pair_loglik_classes(
                feats[:, si],
                mask[:, si],
                bias_alt[:, si],
                bias_ref[:, si],
                bias_any[:, si],
                nu_u,
                kappa_u,
            )  # [L,B,U]
            out[si] = ll_u[:, :, inv]  # [L,B,Gc,Gp]
        return out

    def _run_impl(
        self,
        feats,
        mask,
        bias_alt,
        bias_ref,
        bias_any,
        combo_active,
        branch_gates,
        ln_prior_absent,
        ln_prior_joint=None,
        n_artifact_active=None,
        ln_prior_idx=None,
    ):
        L, S, D, _ = feats.shape
        B = bias_alt.shape[2]
        NB = self.n_branches

        n_obs = mask.sum(dim=-1).to(torch.float32)  # [L,S]

        # own-likelihood grids only for contamination roots
        loglik = {}
        for si in self.root_samples:
            loglik[si] = sample_loglik_grid(
                feats[:, si : si + 1],
                mask[:, si : si + 1],
                bias_alt[:, si : si + 1],
                bias_ref[:, si : si + 1],
                bias_any[:, si : si + 1],
                self._values_t[si],
            )[:, 0]  # [L,B,Gi]

        pair_logliks = self._pair_logliks(
            feats, mask, bias_alt, bias_ref, bias_any
        )

        # clear-ref shortcut (generic.rs:270-300)
        p_ref = feats[..., F["prob_ref"]]
        p_alt = feats[..., F["prob_alt"]]
        positive_ref = (p_ref - p_alt) > LN_32
        clear_ref = (n_obs > 10) & torch.all(positive_ref | ~mask, dim=-1)  # [L,S]

        w_list = self._weights_list(n_obs)  # per sample [L,NB,Gi]
        excl0 = self._excl0  # [NB,S]
        w_list = [
            torch.where(
                (clear_ref[:, si][:, None] & excl0[:, si][None])[..., None],
                NEG_INF,
                w_list[si],
            )
            for si in range(S)
        ]

        if ln_prior_joint is not None:
            # --full-prior: the prior is evaluated pointwise on the joint
            # grid instead of the absent-only split
            if ln_prior_idx is None:
                raise ValueError("ln_prior_joint needs ln_prior_idx, each locus's table")
            T = self._full_prior_terms(
                ln_prior_joint, ln_prior_idx, loglik, pair_logliks, w_list,
                branch_gates, combo_active,
            )
            T = torch.where(branch_gates[:, None, :], T, NEG_INF)
            branch_val = torch.where(combo_active[:, :, None], T, NEG_INF)
            return self._assemble(
                branch_val, loglik, pair_logliks, w_list, branch_gates,
                n_artifact_active,
            )

        U, Uzero = self._unit_terms(loglik, pair_logliks, w_list, B)

        dev = feats.device
        T = torch.zeros((L, B, NB), device=dev)
        Z = torch.zeros((L, B, NB), device=dev)
        for key, val in U.items():
            T = T + val
            Z = Z + Uzero[key]
        if self._lfc_t:
            T, Z = self._lfc_terms(T, Z, U, Uzero, loglik, pair_logliks, w_list)

        z0 = self._z0
        T = torch.where(branch_gates[:, None, :], T, NEG_INF)
        Z = torch.where(branch_gates[:, None, :] & z0[None, None], Z, NEG_INF)

        # absent-only prior split (prior.rs:718-761)
        if self.all_uniform_prior:
            branch_val = T
        else:
            pa = ln_prior_absent[:, None, None]
            ln_not_absent = _ln1mexp(pa)
            nonzero_part = torch.where(z0[None, None], _ln_sub_exp(T, Z), T)
            zero_part = torch.where(z0[None, None], Z, NEG_INF)
            branch_val = _ln_add_exp(ln_not_absent + nonzero_part, pa + zero_part)

        branch_val = torch.where(combo_active[:, :, None], branch_val, NEG_INF)
        return self._assemble(
            branch_val, loglik, pair_logliks, w_list, branch_gates,
            n_artifact_active,
        )

    def _assemble(
        self, branch_val, loglik, pair_logliks, w_list, branch_gates,
        n_artifact_active=None,
    ):
        """The events, the posteriors and the per-sample MAP / AFD of a batch
        (``ops/assemble.py``: on the card two kernel launches, the head and
        the tail, around the contractions of the MAP event's densities),
        in the span ``engine.assemble``.  Traced, it marks the stream at
        its start and end: the marks go with the run's pending fetch, whose
        :meth:`fetch_run` counts the stream time between them as
        ``engine.assemble_stream_ns``."""
        with tracing.span("engine.assemble"):
            dev = branch_val.device
            traced = tracing.enabled()
            if traced:
                start = _stream_mark(dev)
            B = branch_val.shape[1]
            joint, marginal, posteriors, combo_joint, best_ev, wsel_list = assemble_head(
                branch_val, branch_gates.contiguous(),
                None if n_artifact_active is None else n_artifact_active.contiguous(),
                self.n_artifact_combos or max(1, B - 1), w_list, self._assemble_t,
            )
            loglik0 = {si: t[:, :1] for si, t in loglik.items()}
            pair0 = {si: t[:, :1] for si, t in pair_logliks.items()}
            U0 = [
                self._component_reduce(comp, loglik0, pair0, wsel_list)
                for comp in self.components
            ]
            d_own = [
                self._component_reduce(
                    self.components[self._comp_of[si]], loglik0, pair0, wsel_list,
                    keep=si,
                )  # [L,1,NB,Gi]
                for si in range(self.n_samples)
            ]
            af, densities_dphred, afd_idx = assemble_tail(
                d_own, U0, self._comp_of, marginal, self._assemble_t
            )
            if traced:
                self._stream_marks.append(
                    ("engine.assemble_stream_ns", start, _stream_mark(dev))
                )
        return {
            "joint": joint,
            "marginal": marginal,
            "posteriors": posteriors,
            "densities_dphred": densities_dphred,  # [L, sum Ki]
            "afd_idx": afd_idx,  # [L, sum Ktop_i]
            "af": af,  # [L,S]
            "combo_joint": combo_joint,
            "best_nonartifact": best_ev,
        }

    # ------------------------------------------------------------------
    def _afd_backbone(self, si):
        """Static strided backbone indices over sample si's subgrid
        (np int32, includes both endpoints)."""
        gi = len(self.active_idx[si])
        k = min(AFD_BACKBONE_K, gi)
        return np.unique(np.round(np.linspace(0, gi - 1, k)).astype(np.int32))

    @property
    def afd_k(self):
        """Per-sample shipped-AFD value widths (top-K + static backbone)."""
        return [
            min(AFD_TOP_K, len(self.active_idx[si]))
            + len(self._afd_backbone(si))
            for si in range(self.n_samples)
        ]

    @property
    def afd_idx_k(self):
        """Per-sample shipped index widths (top-K only)."""
        return [
            min(AFD_TOP_K, len(self.active_idx[si]))
            for si in range(self.n_samples)
        ]

    def expand_afd(self, vals_cat, idx_cat):
        """Scatter compact per-sample AFD blocks back into the shared-grid
        layout [N, S, G] host-side (sentinel 32767 on unshipped slots)."""
        vals_cat = np.asarray(vals_cat)
        idx_cat = np.asarray(idx_cat).astype(np.int64)
        N = vals_cat.shape[0]
        S = self.n_samples
        full = np.full((N, S, self.grid.size), 32767, dtype=np.int16)
        vpos = 0
        ipos = 0
        for si in range(S):
            ktop = self.afd_idx_k[si]
            bb = self._afd_backbone(si).astype(np.int64)
            k = ktop + len(bb)
            idx_full = np.concatenate(
                [
                    idx_cat[:, ipos : ipos + ktop],
                    np.broadcast_to(bb[None, :], (N, len(bb))),
                ],
                axis=1,
            )
            shared_idx = np.asarray(self.active_idx[si])[idx_full]
            np.put_along_axis(
                full[:, si, :], shared_idx, vals_cat[:, vpos : vpos + k], axis=1
            )
            vpos += k
            ipos += ktop
        return full

    # ------------------------------------------------------------------
    def _start_fetch(self, out, mask, L):
        """Queue the device->host copies of the reference's host outputs
        (before the AFD expansion: map_slot from combo_joint, n_obs from the
        mask); returns a :class:`_Pending`, which takes the stream marks of
        the run."""
        dev_out = {
            "posteriors": out["posteriors"],
            "marginal": out["marginal"],
            "af": out["af"],
            "densities_dphred": out["densities_dphred"],
            "afd_idx": out["afd_idx"],
            "best_nonartifact": out["best_nonartifact"].to(torch.int64),
            "map_slot": torch.argmax(out["combo_joint"], dim=1).to(torch.int64),
            "n_obs": torch.clamp(mask.sum(dim=-1), max=32767).to(torch.int64),
        }
        marks, self._stream_marks = self._stream_marks, []
        counts, self._device_counts = self._device_counts, []
        if self.device.type != "cuda":
            return _Pending(dev_out, None, L, marks, counts)
        stream = torch.cuda.current_stream(self.device)

        def to_host(v):
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            return h

        host = {k: to_host(v) for k, v in dev_out.items()}
        counts = [(name, to_host(v)) for name, v in counts]
        event = torch.cuda.Event()
        event.record(stream)
        return _Pending(host, event, L, marks, counts)

    def fetch_run(self, pending):
        """Wait for a pending result and unpack it into the host dict."""
        if pending.event is not None:
            pending.event.synchronize()
        for name, start, end in pending.marks:
            tracing.count(name, _stream_ns(start, end))
        for name, v in pending.counts:
            tracing.count(name, int(v))
        h = {k: v.numpy() for k, v in pending.host.items()}
        host = {
            "posteriors": h["posteriors"],
            "marginal": h["marginal"],
            "af": h["af"],
        }
        host["joint"] = host["posteriors"] + host["marginal"][:, None]
        host["densities_dphred"] = self.expand_afd(
            h["densities_dphred"], h["afd_idx"]
        )
        for k in ("best_nonartifact", "map_slot", "n_obs"):
            host[k] = h[k]
        return host

    def _as_tensor(self, a, dtype=None):
        t = torch.as_tensor(np.asarray(a))
        if dtype is not None:
            t = t.to(dtype)
        tracing.count("engine.h2d_bytes", t.nbytes)
        return t.to(self.device, non_blocking=True)

    def _upload_loci(self, combo_active, branch_gates, ln_prior_absent,
                     ln_prior_joint, n_artifact_active):
        """The per-locus metadata of the dense entries on the device, in
        :meth:`_run_impl`'s order: (combo_active, branch_gates,
        ln_prior_absent, ln_prior_joint or None, n_artifact_active, by
        default the engine's artifact combo count).  ``ln_prior_joint``
        goes as it comes: a tensor already on the device is not copied."""
        f32 = torch.float32
        pa = self._as_tensor(ln_prior_absent, f32)
        if n_artifact_active is None:
            n_art = torch.full(
                pa.shape, float(self.n_artifact_combos or 1), device=self.device
            )
        else:
            n_art = self._as_tensor(n_artifact_active, f32)
        return (
            self._as_tensor(combo_active, torch.bool),
            self._as_tensor(branch_gates, torch.bool),
            pa,
            None if ln_prior_joint is None else self.upload_prior_tables(ln_prior_joint),
            n_art,
        )

    def upload_prior_tables(self, tables):
        """The --full-prior tables [K, G_0, ..., G_{S-1}] as float32 on the
        engine's device, for :meth:`run`, :meth:`run_compact` and
        :meth:`run_wire` to index by locus: a caller uploads them once and
        passes them with every window (tables already there are taken as
        they are)."""
        if isinstance(tables, torch.Tensor) and tables.device == self.device:
            return tables.to(torch.float32)
        return self._as_tensor(tables, torch.float32)

    def run(
        self,
        feats,
        mask,
        bias_alt,
        bias_ref,
        bias_any,
        combo_active,
        branch_gates,
        ln_prior_absent,
        ln_prior_joint=None,
        n_artifact_active=None,
        fetch=True,
        ln_prior_idx=None,
    ):
        """Evaluate posteriors for a locus batch.

        feats [L,S,D,Fe] f32; mask [L,S,D] bool; bias_* [L,S,B,D] f32;
        combo_active [L,B] bool; branch_gates [L,NB] bool; ln_prior_absent
        [L] f32; ln_prior_joint optional, the --full-prior joint prior on
        the per-sample active subgrids: tables [K, G_0, ..., G_{S-1}] f32
        (host, or from :meth:`upload_prior_tables`), given with
        ``ln_prior_idx`` [L] int, each locus's table.  Returns
        the host dict: joint [L,E], posteriors [L,E],
        marginal [L], densities_dphred [L,S,G] int16 (32767 sentinel), af
        [L,S], best_nonartifact [L], map_slot [L], n_obs [L,S].
        fetch=False returns a pending handle for :meth:`fetch_run`."""
        f32 = torch.float32
        with torch.no_grad():
            feats = self._as_tensor(feats, f32)
            m = self._as_tensor(mask, torch.bool)
            out = self._run_impl(
                feats,
                m,
                self._as_tensor(bias_alt, f32),
                self._as_tensor(bias_ref, f32),
                self._as_tensor(bias_any, f32),
                *self._upload_loci(
                    combo_active, branch_gates, ln_prior_absent, ln_prior_joint,
                    n_artifact_active,
                ),
                ln_prior_idx=self._prior_idx(ln_prior_idx),
            )
            pending = self._start_fetch(out, m, feats.shape[0])
        return self.fetch_run(pending) if fetch else pending

    # ------------------------------------------------------------------
    def _prior_idx(self, idx):
        """The per-locus table rows on the device (int64), or None."""
        return None if idx is None else self._as_tensor(idx, torch.int64)

    def _compact_core(self, obs_f16, obs_u8, hil, mask, slot_map, fwd_rate,
                      has_alt, combo_active, branch_gates, ln_prior_absent,
                      ln_prior_joint, n_art, ln_prior_idx=None):
        """Feature expansion + device bias factors + posterior
        (ops.compact_obs wire encoding)."""
        from .compact_obs import bias_factors, expand_features

        feats = expand_features(obs_f16, obs_u8, hil)
        ba, br_, bn = bias_factors(obs_f16, obs_u8, slot_map, fwd_rate, has_alt)
        return self._run_impl(
            feats, mask, ba, br_, bn, combo_active, branch_gates,
            ln_prior_absent, ln_prior_joint=ln_prior_joint,
            n_artifact_active=n_art, ln_prior_idx=ln_prior_idx,
        )

    def run_compact(
        self,
        obs_f16,
        obs_u8,
        hil,
        mask,
        slot_map,
        combo_active,
        branch_gates,
        ln_prior_absent,
        fwd_rate,
        has_alt_loci,
        ln_prior_joint=None,
        n_artifact_active=None,
        fetch=True,
        ln_prior_idx=None,
    ):
        """:meth:`run` from the dense compact encoding (ops.compact_obs):
        obs_f16 [L,S,D,N_CF] f16; obs_u8 [L,S,D,N_CU] u8; hil [L,S,D] i8;
        mask [L,S,D] bool; slot_map [L,Bc] int (FULL_COMBOS index per combo
        slot); combo_active [L,Bc] bool; fwd_rate [L] f32; has_alt_loci [L]
        bool; the rest as in :meth:`run`.  What each shard of a mesh runs
        (``parallel.sharding.run_sharded_compact``), and a ``--full-prior``
        window under a mesh; fetch=False returns a pending handle for
        :meth:`fetch_run`."""
        L = np.asarray(obs_f16).shape[0]
        with tracing.span("engine.dispatch"), torch.no_grad():
            tracing.count("engine.dispatches", 1)
            loci = self._upload_loci(
                combo_active, branch_gates, ln_prior_absent, ln_prior_joint,
                n_artifact_active,
            )
            m = self._as_tensor(mask, torch.bool)
            out = self._compact_core(
                self._as_tensor(obs_f16, torch.float16),
                self._as_tensor(obs_u8, torch.uint8),
                self._as_tensor(hil, torch.int8),
                m,
                self._as_tensor(slot_map, torch.int64),
                self._as_tensor(fwd_rate, torch.float32),
                self._as_tensor(has_alt_loci, torch.bool),
                *loci,
                ln_prior_idx=self._prior_idx(ln_prior_idx),
            )
            pending = self._start_fetch(out, m, L)
        return self.fetch_run(pending) if fetch else pending

    # ------------------------------------------------------------------
    def _in_wire_spec(self, Np, L, D, Bc, joint_prior=False):
        """Section layout of the single uint8 input buffer (4-byte aligned
        sections); with ``joint_prior``, ``pj``: each locus's row of the
        --full-prior tables."""
        from .compact_obs import N_CF, N_CU

        S = self.n_samples
        spec = [
            ("f16f", np.float16, (Np, N_CF)),
            ("u8f", np.uint8, (Np, N_CU)),
            ("hilf", np.int8, (Np,)),
            ("counts", np.int32, (L, S)),
            ("sm", np.int32, (L, Bc)),
            ("sa", np.uint8, (L, Bc)),
            ("bg", np.uint8, (L, self.n_branches)),
            ("pa", np.float32, (L,)),
            ("fr", np.float32, (L,)),
            ("hal", np.uint8, (L,)),
            ("n_art", np.float32, (L,)),
        ]
        if joint_prior:
            spec.append(("pj", np.int32, (L,)))
        return spec

    def pack_wire(self, arrays, Np, L, D, Bc, joint_prior=False):
        """Host side: the uint8 input buffer of :meth:`run_wire` (same
        dimensions) from its named sections: the flat observation rows
        ``f16f`` [Np,N_CF], ``u8f`` [Np,N_CU], ``hilf`` [Np], the per-sample
        ``counts`` [L,S], and the per-locus ``sm``, ``sa`` [L,Bc], ``bg``
        [L,NB], ``pa``, ``fr``, ``hal``, ``n_art`` [L] and, with
        ``joint_prior``, ``pj`` [L] (each locus's row of the --full-prior
        tables)."""
        parts = []
        for name, dtype, shape in self._in_wire_spec(Np, L, D, Bc, joint_prior):
            a = np.ascontiguousarray(
                np.asarray(arrays[name]).astype(dtype, copy=False)
            ).reshape(-1)
            b = a.view(np.uint8)
            pad = (-b.size) % 4
            parts.append(b)
            if pad:
                parts.append(np.zeros(pad, np.uint8))
        return np.concatenate(parts)

    def run_wire(
        self,
        wire_in,  # uint8 host buffer from pack_wire
        Np,
        L,
        D,
        Bc,
        prior_tables=None,
        fetch=True,
    ):
        """Engine dispatch from ONE uint8 input buffer carrying the flat
        observation rows + all per-locus metadata.  The buffer is copied to
        the device once and the [L,S,D] panels are rebuilt there by gather
        (segment offsets from the shipped counts; rows past a segment read
        an appended fill row).  With ``prior_tables`` (--full-prior: the
        [K, G_0, ..., G_{S-1}] tables, from :meth:`upload_prior_tables`), the
        buffer's ``pj`` section holds each locus's row of them.
        fetch=False returns a pending handle."""
        from ..evidence.observation import HOMOPOLYMER_NONE as _HN
        from .compact_obs import N_CF, N_CU

        S = self.n_samples
        Ls, Ds = int(L), int(D)
        joint = prior_tables is not None
        spec = self._in_wire_spec(int(Np), Ls, Ds, int(Bc), joint)
        dev = self.device
        with tracing.span("engine.dispatch"), torch.no_grad():
            tracing.count("engine.dispatches", 1)
            host = np.asarray(wire_in, dtype=np.uint8)
            tracing.count("engine.h2d_bytes", host.nbytes)
            buf = torch.as_tensor(host).to(dev, non_blocking=True)
            sec = {}
            off = 0
            for name, dtype, shape in spec:
                jd = np.dtype(dtype)
                nbytes = int(np.prod(shape)) * jd.itemsize
                raw = buf[off : off + nbytes]
                sec[name] = raw.view(_TORCH_DTYPES[jd]).reshape(shape)
                off = off + nbytes + (-nbytes) % 4
            counts = torch.clamp(sec["counts"].reshape(-1).to(torch.int64), max=Ds)
            seg_off = torch.cumsum(counts, 0) - counts  # exclusive
            rows = Ls * S * Ds
            ar = torch.arange(rows, device=dev)
            ls = ar // Ds
            slot = ar % Ds
            valid = slot < counts[ls]
            srcc = torch.where(valid, seg_off[ls] + slot, int(Np))
            f16 = torch.cat(
                [sec["f16f"], torch.zeros((1, N_CF), dtype=torch.float16, device=dev)]
            )[srcc]
            u8 = torch.cat(
                [sec["u8f"], torch.zeros((1, N_CU), dtype=torch.uint8, device=dev)]
            )[srcc]
            hil = torch.cat(
                [sec["hilf"], torch.full((1,), _HN, dtype=torch.int8, device=dev)]
            )[srcc]
            mask = valid.reshape(Ls, S, Ds)
            out = self._compact_core(
                f16.reshape(Ls, S, Ds, N_CF),
                u8.reshape(Ls, S, Ds, N_CU),
                hil.reshape(Ls, S, Ds),
                mask,
                sec["sm"],
                sec["fr"],
                sec["hal"] != 0,
                sec["sa"] != 0,
                sec["bg"] != 0,
                sec["pa"],
                self.upload_prior_tables(prior_tables) if joint else None,
                sec["n_art"],
                ln_prior_idx=sec["pj"].to(torch.int64) if joint else None,
            )
            pending = self._start_fetch(out, mask, Ls)
        return self.fetch_run(pending) if fetch else pending
