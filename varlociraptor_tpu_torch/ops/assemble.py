"""The engine's event and MAP / AFD pass (two hand-written CUDA kernels and
their plain twins).

``PosteriorEngine._assemble`` turns a window's branch values [L, B, NB]
into its outputs in two steps around the contractions of
``_component_reduce``:

* the head: the events' joint [L, E] (a non-artifact event at the
  no-artifact combination slot, an artifact event over the other slots
  under its split prior), the marginal and the posteriors, the artifact
  mass a combination ``combo_joint`` [L, B] (slot 0 at -inf), the MAP
  non-artifact event ``best_nonartifact`` [L] and each sample's selection
  ``wsel`` [L, NB, Gi]: 0 where the branch belongs to that event, is gated
  on and has a finite weight, -inf elsewhere; the contractions integrate it;
* the tail: per sample the density over its grid, dens = logsumexp over the
  branches of the kept contraction ``d_own`` [L, 1, NB, Gi] plus the other
  components' sums ``U0``; the MAP allele frequency with the log-parabola
  refinement; the density against the marginal in deci-PHRED int16 at the
  top-K points and at the static backbone.

Counterpart of the same steps of
``varlociraptor_tpu/ops/posterior.py:PosteriorEngine._run_impl`` (lines
1531-1705), which XLA compiles; the kernels are ``csrc/assemble.cu``.  A CPU
tensor goes to the plain versions, a CUDA tensor to the kernels, or the
call raises.

What the kernels take that the plain versions do not need: at most
``MAX_SAMPLES`` (16) samples, so as many components (each sample's tables
travel in the launch's parameters); at most as many branches as four
warps' rows of floats fit in a block's shared memory (14,528 on an H100,
whose blocks may opt in to 227 KB); grids of at most ``MAX_GRID`` points,
as the int16 indices the pass ships hold.  Past these a CUDA call raises,
where the plain versions run; any number of events, combination slots and
loci.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import tracing
from .likelihood import NEG_INF, _lse

PROB_05 = math.log(0.5)
# the kernels' per-launch tables hold at most this many samples
MAX_SAMPLES = 16
# a top-K index and a grid index travel as int16
MAX_GRID = 32767


class AssembleTables:
    """The engine's constant tables of the pass, on its device: the event ->
    branch lists as CSR (``ev_ptr`` [E + 1], ``ev_br``), the artifact events
    (``ev_art`` [E] uint8) and their branches (``art_br``), each branch's
    event (``branch_event`` [NB]), each sample's grid values and AFD
    backbone, and ``top_k`` (the densest points shipped a sample); indices
    int64.  The plain versions read the same tables."""

    def __init__(self, event_branch_idx, event_is_artifact, branch_event, values,
                 backbones, top_k, device):
        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        E = len(event_branch_idx)
        self.n_events = E
        self.n_branches = len(branch_event)
        self.is_artifact = [bool(a) for a in event_is_artifact]
        ptr = np.zeros(E + 1, dtype=np.int64)
        ptr[1:] = np.cumsum([len(ix) for ix in event_branch_idx])
        self.ev_ptr = t(ptr)
        self.ev_br = t([bi for ix in event_branch_idx for bi in ix] or [0])
        # each event's branches, None for an event compiled to False
        self.event_idx = [
            self.ev_br[ptr[e]:ptr[e + 1]] if ptr[e + 1] > ptr[e] else None for e in range(E)
        ]
        self.ev_art = t(self.is_artifact, torch.uint8)
        self.nonart = self.ev_art == 0
        art = [bi for ei in range(E) if self.is_artifact[ei] for bi in event_branch_idx[ei]]
        self.n_art_br = len(art)
        self.art_br = t(art or [0])
        self.artifact_idx = self.art_br if art else None
        self.branch_event = t(np.asarray(branch_event, dtype=np.int64))
        self.values = list(values)
        self.backbone = [t(np.asarray(b, dtype=np.int64)) for b in backbones]
        self.top_k = [min(top_k, int(v.shape[0])) for v in self.values]


# ---------------------------------------------------------------------------
# the plain versions (the engine's body as it was)


def assemble_head_reference(branch_val, branch_gates, n_artifact_active, n_artifact_combos,
                            w_list, tables):
    """(joint [L,E], marginal [L], posteriors [L,E], combo_joint [L,B],
    best_nonartifact [L] int64, wsel per sample [L,NB,Gi])."""
    L, B = branch_val.shape[0], branch_val.shape[1]
    dev = branch_val.device
    # the artifact event splits a 0.5 prior uniformly over the bias
    # combinations considered at each locus (generic.rs:437-441)
    if n_artifact_active is not None:
        ln_n_art = torch.log(torch.clamp(n_artifact_active, min=1.0))  # [L]
    else:
        ln_n_art = torch.full((L,), math.log(n_artifact_combos), device=dev)
    event_vals = []
    for ei in range(tables.n_events):
        if tables.event_idx[ei] is None:
            # event compiled to False (e.g. impossible on this contig)
            event_vals.append(torch.full((L,), NEG_INF, device=dev))
            continue
        bv = branch_val[:, :, tables.event_idx[ei]]  # [L,B,nb_e]
        ev_b = _lse(bv, dim=-1)  # [L,B]
        if tables.is_artifact[ei]:
            if B == 1:  # no artifact combo slot active in this batch
                val = torch.full((L,), NEG_INF, device=dev)
            else:
                bias_prior = PROB_05 - ln_n_art  # [L]
                val = bias_prior + _lse(ev_b[:, 1:], dim=-1)
        else:
            val = PROB_05 + ev_b[:, 0]
        event_vals.append(val)
    joint = torch.stack(event_vals, dim=-1)  # [L,E]
    marginal = _lse(joint, dim=-1)
    posteriors = joint - marginal[:, None]

    # per-combo artifact mass (MAP artifact-combination reporting)
    if tables.artifact_idx is not None:
        combo_joint = _lse(branch_val[:, :, tables.artifact_idx], dim=-1)
        # slot 0 (no-artifact) never carries artifact-event mass
        combo_joint = combo_joint.clone()
        combo_joint[:, 0] = NEG_INF
    else:
        combo_joint = torch.full((L, B), NEG_INF, device=dev)

    # the per-locus MAP non-artifact event, whose branches the per-sample
    # marginal densities (MAP / AFD) integrate at the no-artifact bias slot
    # (calling.rs:844-937)
    masked_joint = torch.where(tables.nonart[None, :], joint, NEG_INF)
    best_ev = torch.argmax(masked_joint, dim=-1)  # [L]
    sel = (tables.branch_event[None, :] == best_ev[:, None]) & branch_gates  # [L,NB]
    wsel_list = []
    for w in w_list:
        wmask = torch.where(w > NEG_INF / 2, 0.0, NEG_INF)
        wsel_list.append(wmask + torch.where(sel[:, :, None], 0.0, NEG_INF))
    return joint, marginal, posteriors, combo_joint, best_ev, wsel_list


def assemble_tail_reference(d_own, U0, comp_of, marginal, tables):
    """(af [L,S], densities_dphred [L, sum of K_i + backbone_i] int16,
    afd_idx [L, sum of K_i] int16) from each sample's kept contraction
    d_own[si] [L,1,NB,Gi], the components' sums U0[c] [L,1,NB] and the
    component of each sample ``comp_of``."""
    L = marginal.shape[0]
    NB = tables.n_branches
    dev = marginal.device
    # MAP AF with log-parabola off-grid refinement; AFD as
    # marginal-normalized deci-PHRED int16 (32767 = -inf / not shipped)
    af_cols = []
    dphred_blocks = []
    afd_idx_blocks = []
    for si, own in enumerate(d_own):
        rest = torch.zeros((L, 1, NB), device=dev)
        for c, val in enumerate(U0):
            if c != comp_of[si]:
                rest = rest + val
        d = own + rest[..., None]  # [L,1,NB,Gi]
        dens = _lse(d[:, 0], dim=1)  # [L,Gi]

        vals = tables.values[si]
        Gi = dens.shape[-1]
        gi = torch.argmax(dens, dim=-1)  # [L]
        if Gi >= 3:
            gi_c = torch.clamp(gi, 1, Gi - 2)
            dm = torch.gather(dens, -1, (gi_c - 1)[:, None])[:, 0]
            d0 = torch.gather(dens, -1, gi_c[:, None])[:, 0]
            dp = torch.gather(dens, -1, (gi_c + 1)[:, None])[:, 0]
            g_at = vals[gi_c]
            left = g_at - vals[gi_c - 1]
            right = vals[gi_c + 1] - g_at
            # unequal-spacing parabola vertex through the three points
            num = (dm - d0) * right * right - (dp - d0) * left * left
            den = (dm - d0) * right + (dp - d0) * left
            off = torch.where(den < -1e-12, 0.5 * num / den, 0.0)
            af_ref = torch.minimum(
                torch.maximum(g_at + off, vals[gi_c - 1]), vals[gi_c + 1]
            )
            ok = (
                (gi >= 1)
                & (gi <= Gi - 2)
                & torch.isfinite(dm)
                & torch.isfinite(dp)
                & (torch.abs(off) <= torch.maximum(left, right))
                & (den < -1e-12)
            )
            af_cols.append(torch.where(ok, af_ref, vals[gi]))
        else:
            af_cols.append(vals[gi])

        rel = dens - marginal[:, None]
        dphred = -10.0 / math.log(10.0) * rel * 10.0
        dphred_i16 = torch.where(
            torch.isfinite(rel),
            torch.clamp(torch.round(dphred), -32767.0, 32766.0),
            32767.0,  # sentinel: dropped by the AFD writer
        ).to(torch.int16)
        # top-K (ties to the lower index, as lax.top_k) + static backbone
        K = tables.top_k[si]
        top_idx = torch.sort(dens, dim=-1, descending=True, stable=True)[1][:, :K]
        bb = tables.backbone[si][None, :].expand(L, -1)
        idx_all = torch.cat([top_idx, bb], dim=-1)
        dphred_blocks.append(torch.gather(dphred_i16, -1, idx_all))
        afd_idx_blocks.append(top_idx.to(torch.int16))
    af = torch.stack(af_cols, dim=1)  # [L,S]
    return af, torch.cat(dphred_blocks, dim=1), torch.cat(afd_idx_blocks, dim=1)


# ---------------------------------------------------------------------------
# the kernels' wrappers


def _need(cond, what):
    if not cond:
        raise ValueError(f"assemble: {what}")


def _float32(name, x, rank, dev):
    if x.dtype != torch.float32:
        raise TypeError(f"assemble: {name} must be float32, got {x.dtype}")
    _need(x.dim() == rank, f"{name} must have rank {rank}, got {tuple(x.shape)}")
    _need(x.device == dev, f"{name} on {x.device}, expected on {dev}")


def _device(dev, fn):
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    return True


def _ptrs(values):
    return ctypes.c_void_p(values.ctypes.data)


def assemble_head(branch_val, branch_gates, n_artifact_active, n_artifact_combos, w_list,
                  tables):
    """The head of the pass (see the module's docstring): branch_val
    [L,B,NB] f32, branch_gates [L,NB] bool, n_artifact_active [L] f32 or
    None (then every locus splits over ``n_artifact_combos``), w_list per
    sample [L,NB,Gi] f32, all contiguous.  CPU tensors: the plain version.
    CUDA tensors: one launch of the kernel (counted in
    ``assemble_head.launches`` and the trace counter
    ``engine.assemble_launches``)."""
    dev = branch_val.device
    _float32("branch_val", branch_val, 3, dev)
    L, B, NB = branch_val.shape
    _need(NB == tables.n_branches, f"branch_val has {NB} branches, the tables {tables.n_branches}")
    _need(branch_gates.dtype == torch.bool and tuple(branch_gates.shape) == (L, NB),
          f"branch_gates must be bool [L, NB] = {(L, NB)}, got {branch_gates.dtype} "
          f"{tuple(branch_gates.shape)}")
    _need(branch_gates.device == dev, f"branch_gates on {branch_gates.device}, expected on {dev}")
    if n_artifact_active is not None:
        _float32("n_artifact_active", n_artifact_active, 1, dev)
        _need(n_artifact_active.shape[0] == L, "n_artifact_active must be [L]")
    _need(len(w_list) == len(tables.values), f"{len(w_list)} weights, {len(tables.values)} samples")
    for si, w in enumerate(w_list):
        _float32(f"w_list[{si}]", w, 3, dev)
        _need(tuple(w.shape) == (L, NB, tables.values[si].shape[0]),
              f"w_list[{si}] must be [L, NB, Gi] = {(L, NB, tables.values[si].shape[0])}, "
              f"got {tuple(w.shape)}")
    if not _device(dev, "assemble_head"):
        return assemble_head_reference(branch_val, branch_gates, n_artifact_active,
                                       n_artifact_combos, w_list, tables)
    args = [branch_val, branch_gates, *w_list]
    if n_artifact_active is not None:
        args.append(n_artifact_active)
    _need(all(x.is_contiguous() for x in args), "the head's inputs must be contiguous")
    _need(tables.ev_ptr.device == dev, f"the tables on {tables.ev_ptr.device}, expected on {dev}")
    S = len(w_list)
    _need(S <= MAX_SAMPLES, f"{S} samples, the kernel takes at most {MAX_SAMPLES}")
    from .._build import load

    lib = load()
    E = tables.n_events
    f32 = dict(dtype=torch.float32, device=dev)
    joint = torch.empty((L, E), **f32)
    marginal = torch.empty((L,), **f32)
    posteriors = torch.empty((L, E), **f32)
    combo_joint = torch.empty((L, B), **f32)
    best = torch.empty((L,), dtype=torch.int64, device=dev)
    wsel = [torch.empty_like(w) for w in w_list]
    # per sample: the weights, the selection, the grid size
    per = np.array([[w.data_ptr(), o.data_ptr(), w.shape[2]] for w, o in zip(w_list, wsel)],
                   dtype=np.int64)
    ln_n_art = float(np.float32(math.log(n_artifact_combos)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vlt_assemble_head(
            branch_val.data_ptr(), branch_gates.data_ptr(),
            None if n_artifact_active is None else n_artifact_active.data_ptr(), ln_n_art,
            tables.ev_ptr.data_ptr(), tables.ev_br.data_ptr(), tables.ev_art.data_ptr(),
            tables.art_br.data_ptr(), tables.n_art_br, tables.branch_event.data_ptr(),
            L, B, NB, E, S, _ptrs(per), joint.data_ptr(), marginal.data_ptr(),
            posteriors.data_ptr(), combo_joint.data_ptr(), best.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"assemble head kernel launch failed: CUDA error {err}")
    assemble_head.launches += 1
    tracing.count("engine.assemble_launches", 1)
    return joint, marginal, posteriors, combo_joint, best, wsel


def assemble_tail(d_own, U0, comp_of, marginal, tables):
    """The tail of the pass (see the module's docstring): d_own per sample
    [L,1,NB,Gi] f32 at any strides, U0 per component [L,1,NB] f32 at any
    strides, comp_of [S] the component of each sample, marginal [L] f32
    contiguous.  CPU tensors: the plain version.  CUDA tensors: one launch
    of the kernel, every sample in it (counted in ``assemble_tail.launches``
    and the trace counter ``engine.assemble_launches``)."""
    dev = marginal.device
    _float32("marginal", marginal, 1, dev)
    L = marginal.shape[0]
    NB = tables.n_branches
    S = len(tables.values)
    _need(len(d_own) == S and len(comp_of) == S, f"d_own and comp_of must have {S} entries")
    _need(all(0 <= c < len(U0) for c in comp_of), "comp_of names a component not in U0")
    for si, d in enumerate(d_own):
        _float32(f"d_own[{si}]", d, 4, dev)
        Gi = tables.values[si].shape[0]
        _need(tuple(d.shape) == (L, 1, NB, Gi),
              f"d_own[{si}] must be [L, 1, NB, Gi] = {(L, 1, NB, Gi)}, got {tuple(d.shape)}")
    for c, u in enumerate(U0):
        _float32(f"U0[{c}]", u, 3, dev)
        _need(tuple(u.shape) == (L, 1, NB), f"U0[{c}] must be [L, 1, NB], got {tuple(u.shape)}")
    if not _device(dev, "assemble_tail"):
        return assemble_tail_reference(d_own, U0, comp_of, marginal, tables)
    _need(marginal.is_contiguous(), "marginal must be contiguous")
    _need(tables.ev_ptr.device == dev, f"the tables on {tables.ev_ptr.device}, expected on {dev}")
    _need(S <= MAX_SAMPLES and len(U0) <= MAX_SAMPLES,
          f"{S} samples, {len(U0)} components: the kernel takes at most {MAX_SAMPLES}")
    _need(all(v.shape[0] <= MAX_GRID for v in tables.values),
          f"a grid of more than {MAX_GRID} points")
    from .._build import load

    lib = load()
    widths = [k + b.shape[0] for k, b in zip(tables.top_k, tables.backbone)]
    wv, wi = sum(widths), sum(tables.top_k)
    af = torch.empty((L, S), dtype=torch.float32, device=dev)
    dphred = torch.empty((L, wv), dtype=torch.int16, device=dev)
    afd_idx = torch.empty((L, wi), dtype=torch.int16, device=dev)
    # per sample: d_own and its strides (l, nb, g), Gi, its component, the
    # grid values, the backbone and its length, K, the column offsets
    per, ov, oi = [], 0, 0
    for si, d in enumerate(d_own):
        bb = tables.backbone[si]
        per.append([d.data_ptr(), d.stride(0), d.stride(2), d.stride(3), d.shape[3], comp_of[si],
                    tables.values[si].data_ptr(), bb.data_ptr(), bb.shape[0],
                    tables.top_k[si], ov, oi])
        ov, oi = ov + widths[si], oi + tables.top_k[si]
    per = np.array(per, dtype=np.int64)
    comps = np.array([[u.data_ptr(), u.stride(0), u.stride(2)] for u in U0], dtype=np.int64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vlt_assemble_tail(
            _ptrs(per), S, _ptrs(comps), len(U0), L, NB, marginal.data_ptr(), af.data_ptr(),
            dphred.data_ptr(), wv, afd_idx.data_ptr(), wi, stream,
        )
    if err != 0:
        raise RuntimeError(f"assemble tail kernel launch failed: CUDA error {err}")
    assemble_tail.launches += 1
    tracing.count("engine.assemble_launches", 1)
    return af, dphred, afd_idx


assemble_head.launches = 0
assemble_tail.launches = 0
