"""Columnar calling (torch port of ``varlociraptor_tpu/calling/fastcall.py``).

Same semantics as the reference's per-WorkItem path
(``calling/variants/calling.rs:320-455``), restructured around
``ColumnarBatch`` + ``PosteriorEngine.run_wire``: per-locus Python work is
replaced by O(N_obs) numpy reductions, and each window ships to the engine's
device as one uint8 buffer (flat observation rows + per-locus metadata).
Over a device mesh a window ships as dense padded panels instead, split over
the mesh's shards (``parallel.sharding.run_sharded_compact``; a
``--full-prior`` window runs ``PosteriorEngine.run_compact`` on the caller's
device).

Output records are built by a vectorized formatter (integer-coded audit
strings counted with np.unique instead of per-read Counters).
"""

from __future__ import annotations

import numpy as np

from ..evidence.observation import (
    ALT_LOCUS_MAJOR,
    ALT_LOCUS_SOME,
    HOMOPOLYMER_NONE,
    RO_F1R2,
    RO_F2R1,
    RO_NONE,
    STRAND_BOTH,
    STRAND_FORWARD,
    STRAND_REVERSE,
)
from ..io.vcf import VcfRecord
from ..ops.biases import FULL_COMBOS_DEFAULT as FULL_COMBOS
from ..ops.compact_obs import (
    CU_ALT_LOCUS,
    CU_FLAGS,
    CU_RO,
    CU_STRAND,
    FLAG_IS_MAX_MAPQ,
    FLAG_PAIRED,
    FLAG_SOFTCLIPPED,
)
from ..utils.logprob import np_phred_from_log
from .call import GenericCaller, _FORMAT_KEYS
from .columnar import ColumnarBatch, compact_slots

_N_COMBOS = len(FULL_COMBOS)

# letter for a Kass-Raftery level given the log Bayes factor (vectorized
# twin of call._bf_letter; d = ln(bf) > 0 by construction where used)
_KR_EDGES = np.log(np.array([1.0, 3.2, 10.0, 100.0]))
_KR_LETTERS = "NBPSV"


def _allowed_matrix(flags):
    """[L, n_combos] pre-gate from the per-locus consider flags
    (columns: ro, sb, rp, sc, he, al — matching make_work_item)."""
    L = flags.shape[0]
    allowed = np.ones((L, _N_COMBOS), dtype=bool)
    for ci, c in enumerate(FULL_COMBOS):
        if c.strand:
            allowed[:, ci] &= flags[:, 1]
        if c.read_orientation:
            allowed[:, ci] &= flags[:, 0]
        if c.read_position:
            allowed[:, ci] &= flags[:, 2]
        if c.softclip:
            allowed[:, ci] &= flags[:, 3]
        if c.homopolymer:
            allowed[:, ci] &= flags[:, 4]
        if c.alt_locus:
            allowed[:, ci] &= flags[:, 5]
    return allowed


_INT_TBL = None


def _int_strings(a):
    """Vectorized small-int -> str (table lookup; %d fallback for rare
    large values)."""
    global _INT_TBL
    if _INT_TBL is None:
        _INT_TBL = np.array([str(i) for i in range(4096)], dtype=object)
    if a.size and a.max() >= 4096:
        return np.char.mod("%d", a).astype(object)
    return _INT_TBL[a]


class _PhredStrings:
    """Lazy lookup table: deci-PHRED int16 -> '%.2f' string."""

    _tbl = None
    _tbl_np = None

    @classmethod
    def table(cls):
        if cls._tbl is None:
            cls._tbl = [f"{v / 10.0:.2f}" for v in range(32767)]
        return cls._tbl

    @classmethod
    def table_np(cls):
        if cls._tbl_np is None:
            cls._tbl_np = np.asarray(cls.table(), dtype=object)
        return cls._tbl_np


class PendingWindow:
    """Dispatched-but-unfetched engine window (dispatch-ahead pipeline).

    Each pending bucket holds the engine's pinned host copies and the CUDA
    event recorded after them, so ``finish`` may run on any thread."""

    def __init__(self, engine, L, groups, meta):
        self.engine = engine
        self.L = L
        self.groups = groups
        self.meta = meta

    def finish(self):
        """Materialize all bucket outputs and merge in locus order."""
        out = None
        for idx, Lb, pending in self.groups:
            # a bucket sharded over a mesh arrives fetched
            sub = pending if isinstance(pending, dict) else self.engine.fetch_run(pending)
            if out is None:
                out = {
                    k: np.zeros((self.L,) + v.shape[1:], dtype=v.dtype)
                    for k, v in sub.items()
                }
            for k, v in sub.items():
                out[k][idx] = v[:Lb]
        return out, self.meta


# pad values of the per-locus arrays on the locus axis past a bucket's loci
# (the wire's section names); a padding locus also gets its first combo slot
# active
_LOCUS_FILL = {"sm": 0, "sa": False, "bg": True, "pa": 0.0, "fr": 0.5,
               "hal": False, "n_art": 1.0, "pj": 0}


def _pad_rows(a, n, fill=0):
    """``a`` with its first axis padded to ``n`` rows of ``fill``."""
    padded = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    padded[: len(a)] = a
    return padded


def _bucket_loci(loci, idx, Lp):
    """The per-locus arrays of the loci ``idx``, padded to ``Lp`` rows."""
    out = {k: _pad_rows(a[idx], Lp, _LOCUS_FILL[k])
           for k, a in loci.items() if a is not None}
    out["sa"][len(idx):, 0] = True
    return out


class ColumnarCaller(GenericCaller):
    """GenericCaller with the vectorized columnar batch path."""

    def call_window_cb(self, cb: ColumnarBatch, contig, sync=True):
        """Run a columnar window through the engine.  Returns
        (out dict sliced to [L], meta dict with the per-locus decisions the
        formatter needs).  sync=False returns a PendingWindow instead: the
        device computes while the caller formats the previous window; call
        ``.finish()`` for (out, meta).  Without a mesh the window takes the
        wire (:meth:`_dispatch_wire`), over a mesh the dense panels
        (:meth:`_dispatch_panels`)."""
        events, grid = self._events_for(contig)
        engine = self._engine_for(contig, events, grid)
        L = cb.L
        S = cb.S

        flags, is_snv_mnv, snv_keys = cb.locus_flags(self.options)
        cb.apply_nonstandard_filter(
            is_snv_mnv, self.options.omit_read_orientation_bias
        )
        cb.apply_singleton_adjust()

        allowed = _allowed_matrix(flags)
        combo_active, fwd_rate, has_alt_loci = cb.learn_and_gate(allowed)
        n_artifact_active = np.maximum(
            allowed[:, 1:].sum(axis=1), 1
        ).astype(np.float32)
        slot_map, slot_active = compact_slots(combo_active)

        # branch gates via the snv-key cache (<= 17 distinct keys)
        gate_cache = self._snv_gate_cache = getattr(
            self, "_snv_gate_cache", {}
        )
        eng_key = id(engine)
        branch_gates = np.ones((L, engine.n_branches), dtype=bool)
        for li, key in enumerate(snv_keys):
            ck = (eng_key, key)
            g = gate_cache.get(ck)
            if g is None:
                g = np.array(
                    [br.passes_snv(key) for (ei, br) in engine.branches]
                )
                gate_cache[ck] = g
            branch_gates[li] = g

        # priors via unique (vartype, overrides) keys; --full-prior adds each
        # locus's row of the joint prior tables on the engine's per-sample
        # active subgrids, which go to the device once per key
        ln_prior_absent = np.zeros(L, dtype=np.float32)
        full_prior = self.options.full_prior
        prior_rows = np.zeros(L, dtype=np.int32) if full_prior else None
        pa_cache = {}
        for li, v in enumerate(cb.variants):
            pkey = (v.kind, v.heterozygosity, v.somatic_effective_mutation_rate)
            hit = pa_cache.get(pkey)
            if hit is None:
                prior = self._prior_for(contig, v.kind)
                prior.variant_heterozygosity = v.heterozygosity
                prior.variant_somatic_rate = v.somatic_effective_mutation_rate
                pa = prior.prob_absent()
                row = self._joint_prior_row(engine, v, prior) if full_prior else None
                hit = pa_cache[pkey] = (pa, row)
            ln_prior_absent[li] = hit[0]
            if full_prior:
                prior_rows[li] = hit[1]
        tables = self._joint_prior_tables(engine) if full_prior else None

        loci = {"sm": slot_map, "sa": slot_active, "bg": branch_gates,
                "pa": ln_prior_absent, "fr": fwd_rate, "hal": has_alt_loci,
                "n_art": n_artifact_active, "pj": prior_rows}
        d_l = cb.counts.max(axis=1) if cb.counts.size else np.ones(L, int)
        d_l = np.maximum(d_l, 1)
        counts_full = np.zeros((L, S), dtype=np.int64)
        dispatch = self._dispatch_wire if self.mesh is None else self._dispatch_panels
        groups = dispatch(engine, cb, d_l, loci, counts_full, tables)
        meta = {
            "slot_map": slot_map,
            "counts": counts_full,
            "grid": grid,
            "events": events,
        }
        pw = PendingWindow(engine, L, groups, meta)
        if sync:
            return pw.finish()
        return pw

    def _bucket_len(self, Lb, side=False):
        """The padded locus axis of a depth bucket of ``Lb`` loci: the
        wire's rare deep-pileup ``side`` bucket has a small fixed one; tail
        windows of a long run reuse the full-window shape."""
        batch_cap = max(self.options.effective_batch(columnar=True), 1)
        if side:
            Lp = max(256, 1 << (Lb - 1).bit_length())
        elif getattr(self, "_seen_full_window", False):
            Lp = batch_cap
        else:
            Lp = min(batch_cap, max(64, 1 << (Lb - 1).bit_length()))
        Lp = max(Lp, Lb)
        if Lp >= batch_cap:
            self._seen_full_window = True
        return Lp

    def _dispatch_wire(self, engine, cb, d_l, loci, counts_full, tables):
        """No mesh: each depth bucket ships as ONE uint8 buffer (flat
        observation rows + per-locus metadata, ``engine.pack_wire``) and the
        device rebuilds its panels by gather (``engine.run_wire``); the
        --full-prior ``tables`` are already on the device.  Returns the
        buckets' (locus indices, locus count, pending handle)."""
        # STATIC two-bucket depth routing: one "bulk" bucket at D=64 (covers
        # WGS-typical pileups) and one rare "deep" bucket at the pow2 of the
        # window's deepest pileup (>= 128).  Few distinct shapes keep the
        # per-shape host work (and later graph capture) cheap.
        deep_d = 1 << int(np.ceil(np.log2(max(int(d_l.max()), 2))))
        deep_d = max(deep_d, 128)
        dbucket = np.where(d_l <= 64, 64, deep_d).astype(np.int64)
        groups = []
        for depth in np.unique(dbucket):
            depth = int(depth)
            idx = np.nonzero(dbucket == depth)[0]
            Lb = len(idx)
            Lp = self._bucket_len(Lb, side=depth > 64)
            f16f, u8f, hilf, rowf, counts = cb.pack_flat(depth, locus_idx=idx)
            counts_full[idx] = counts
            # bucket the flat obs axis (pow2 and 1.5*pow2 steps, >=4096)
            N = len(rowf)
            p2 = 1 << max(0, (N - 1)).bit_length()
            Np = max(4096, p2 // 4 * 3 if N <= p2 // 4 * 3 else p2)
            arrays = _bucket_loci(loci, idx, Lp)
            arrays["f16f"] = _pad_rows(f16f, Np)
            arrays["u8f"] = _pad_rows(u8f, Np)
            arrays["hilf"] = _pad_rows(hilf, Np)
            arrays["counts"] = _pad_rows(counts.astype(np.int32), Lp)
            Bc = arrays["sm"].shape[1]
            buf = engine.pack_wire(arrays, Np, Lp, depth, Bc, tables is not None)
            pending = engine.run_wire(buf, Np, Lp, depth, Bc, prior_tables=tables,
                                      fetch=False)
            groups.append((idx, Lb, pending))
        return groups

    def _dispatch_panels(self, engine, cb, d_l, loci, counts_full, tables):
        """Over a mesh: each depth bucket ships as dense padded panels,
        sharded over the mesh (``parallel.sharding.run_sharded_compact``);
        a ``--full-prior`` window, which carries the joint prior ``tables``,
        runs ``engine.run_compact`` on the caller's device, as in JAX.
        Returns the buckets' (locus indices, locus count, pending handle or
        host dict)."""
        from ..parallel.sharding import run_sharded_compact

        # pow2 depth buckets (>= 16); sparsely populated ones merge upward,
        # so that a few deep pileups do not pad the window
        L = len(d_l)
        dbucket = np.left_shift(1, np.ceil(np.log2(d_l)).astype(np.int64))
        dbucket = np.maximum(dbucket, 16)
        uniq = np.unique(dbucket)
        if len(uniq) > 1:
            on_cpu = engine.device.type == "cpu"
            thresh = max(64, L // 4) if on_cpu else max(64, L // 2)
            for i, b in enumerate(uniq[:-1]):
                sel = dbucket == b
                if sel.sum() < thresh:
                    dbucket[sel] = uniq[i + 1]
        groups = []
        for depth in np.unique(dbucket):
            depth = int(depth)
            idx = np.nonzero(dbucket == depth)[0]
            Lb = len(idx)
            Lp = self._bucket_len(Lb)
            obs_f16, obs_u8, hil, mask, counts = cb.pack_panels(depth, locus_idx=idx)
            counts_full[idx] = counts
            a = _bucket_loci(loci, idx, Lp)
            panels = (_pad_rows(obs_f16, Lp), _pad_rows(obs_u8, Lp),
                      _pad_rows(hil, Lp, HOMOPOLYMER_NONE), _pad_rows(mask, Lp),
                      a["sm"], a["sa"], a["bg"], a["pa"], a["fr"], a["hal"])
            if tables is not None:
                pending = engine.run_compact(*panels, ln_prior_joint=tables,
                                             ln_prior_idx=a["pj"],
                                             n_artifact_active=a["n_art"], fetch=False)
            else:
                pending = run_sharded_compact(engine, self.mesh, *panels,
                                              n_artifact_active=a["n_art"])
            groups.append((idx, Lb, pending))
        return groups

    # ------------------------------------------------------------------
    def _window_panels(self, cb: ColumnarBatch, out, meta):
        """Shared per-window decision panels for both formatters."""
        L = cb.L
        events = meta["events"]
        grid = meta["grid"]

        # ---- event probabilities (PROB_* INFO), ordered like the object
        # path's dict: scenario events in order, then "artifact"
        names = [e.name for e in events if not e.is_artifact] + ["artifact"]
        ev_cols = np.zeros((L, len(names)), dtype=np.float64)
        art_idx = [ei for ei, e in enumerate(events) if e.is_artifact]
        ci = 0
        post = out["posteriors"].astype(np.float64)
        for ei, e in enumerate(events):
            if not e.is_artifact:
                ev_cols[:, ci] = post[:, ei]
                ci += 1
        if art_idx:
            with np.errstate(divide="ignore"):
                m = post[:, art_idx].max(axis=1)
                safe_m = np.where(np.isfinite(m), m, 0.0)
                s = np.exp(post[:, art_idx] - safe_m[:, None]).sum(axis=1)
                ev_cols[:, -1] = np.where(
                    np.isfinite(m), safe_m + np.log(s), -np.inf
                )
        else:
            ev_cols[:, -1] = -np.inf
        best = np.argmax(ev_cols, axis=1)
        is_artifact = best == len(names) - 1

        with np.errstate(divide="ignore", invalid="ignore"):
            phred = np_phred_from_log(ev_cols)
        sorted_names = sorted(names)
        name_order = [names.index(n) for n in sorted_names]

        # ---- per-sample panels
        dp = cb.expected_depths()
        af = out["af"]
        dphred = out["densities_dphred"]  # [L,S,G] int16
        map_slot = out["map_slot"]
        slot_map = meta["slot_map"]
        map_combo_idx = np.where(
            is_artifact,
            slot_map[np.arange(L), map_slot],
            0,
        )

        return {
            "names": names,
            "phred": phred,
            "is_artifact": is_artifact,
            "sorted_names": sorted_names,
            "name_order": name_order,
            "dp": dp,
            "af": af,
            "map_combo_idx": map_combo_idx,
            "afd_strs": self._afd_strings(dphred, grid, is_artifact),
            "obs_strs": self._obs_strings(cb),
            "saobs_strs": self._simple_obs_strings(cb, alt=True),
            "srobs_strs": self._simple_obs_strings(cb, alt=False),
            "missing": cb.counts.sum(axis=1) == 0,
        }

    def format_window(self, cb: ColumnarBatch, out, meta, sample_names):
        """Vectorized result formatting -> list[VcfRecord]."""
        L, S = cb.L, cb.S
        p = self._window_panels(cb, out, meta)
        names = p["names"]
        phred = p["phred"]
        is_artifact = p["is_artifact"]
        name_order = p["name_order"]
        dp = p["dp"]
        af = p["af"]
        map_combo_idx = p["map_combo_idx"]
        afd_strs = p["afd_strs"]
        obs_strs = p["obs_strs"]
        saobs_strs = p["saobs_strs"]
        srobs_strs = p["srobs_strs"]
        missing = p["missing"]

        records = []
        art_labels = [c.short_labels() for c in FULL_COMBOS]
        for li in range(L):
            v = cb.variants[li]
            info = {}
            hints = []
            if cb.hint_filtered[li]:
                hints.append("filtered-non-standard-alignments")
            if cb.hint_singleton[li]:
                hints.append("adjusted-singleton-evidence")
            if missing[li]:
                hints.append("missing-data")
                for n_i in name_order:
                    info[f"PROB_{names[n_i].upper()}"] = "."
            else:
                for n_i in name_order:
                    p = phred[li, n_i]
                    info[f"PROB_{names[n_i].upper()}"] = (
                        f"{p:.4f}" if np.isfinite(p) else "inf"
                    )
            _variant_info_fields(v, info)
            if hints:
                info["HINTS"] = ",".join(hints)
            if getattr(v, "aux_info", None):
                for k, val in v.aux_info.items():
                    info.setdefault(k, val)

            samples = []
            if missing[li]:
                samples = [
                    {k: "." for k in _FORMAT_KEYS} for _ in range(S)
                ]
            else:
                art = art_labels[int(map_combo_idx[li])]
                for si in range(S):
                    if is_artifact[li]:
                        af_s = "0.0000"
                        afd_s = "."
                    else:
                        af_s = f"{af[li, si]:.4f}"
                        afd_s = afd_strs[li * S + si]
                    samples.append(
                        {
                            "DP": str(dp[li, si]),
                            "AF": af_s,
                            "OBS": obs_strs[li * S + si],
                            "SAOBS": saobs_strs[li * S + si],
                            "SROBS": srobs_strs[li * S + si],
                            "OOBS": str(cb.n_filtered[li, si]),
                            "SB": art["SB"],
                            "ROB": art["ROB"],
                            "RPB": art["RPB"],
                            "SCB": art["SCB"],
                            "HE": art["HE"],
                            "ALB": art["ALB"],
                            "AFD": afd_s,
                        }
                    )
            records.append(
                VcfRecord(
                    chrom=v.chrom,
                    pos=v.pos,
                    id=".",
                    ref=v.ref_allele,
                    alts=[v.alt_allele],
                    info=info,
                    format=list(_FORMAT_KEYS),
                    samples=samples,
                )
            )
        return records

    # ------------------------------------------------------------------
    def format_window_text(self, cb: ColumnarBatch, out, meta, sample_names):
        """Fully vectorized text formatting: one VCF text blob for the whole
        window, byte-identical to ``VcfWriter.write`` over
        :meth:`format_window`'s records.  Per-locus Python work only on the
        rare rows (imprecise / haplotype / aux-INFO)."""
        L, S = cb.L, cb.S
        p = self._window_panels(cb, out, meta)
        missing = p["missing"]
        is_artifact = p["is_artifact"]

        def obj(a):
            return np.asarray(a, dtype=object)

        # ---- INFO: PROB_* block (sorted names; '.' on missing rows)
        any_missing = bool(missing.any())
        info_parts = []
        for k, n_i in enumerate(p["name_order"]):
            name = p["sorted_names"][k]
            col = p["phred"][:, n_i]
            col = np.where(np.isfinite(col), col, np.inf)
            s = obj(np.char.mod("%.4f", col))
            if any_missing:
                s[missing] = "."
            prefix = (";" if k else "") + f"PROB_{name.upper()}="
            info_parts.append(prefix)
            info_parts.append(s)
        info = info_parts[0] + info_parts[1]
        for q in range(2, len(info_parts), 2):
            info = info + (info_parts[q] + info_parts[q + 1])

        # ---- variant INFO fields, vectorized by kind
        kinds = np.array([v.kind for v in cb.variants])
        sv_mask = np.isin(
            kinds, ("deletion", "insertion", "inversion", "duplication")
        )
        if sv_mask.any():
            svlen_in = np.array(
                [v.svlen or 0 for v in cb.variants], dtype=np.int64
            )
            lendiff = np.array(
                [len(v.alt_allele) - len(v.ref_allele) for v in cb.variants],
                dtype=np.int64,
            )
            base = np.where(kinds == "deletion", -svlen_in, svlen_in)
            svlen = np.where(base == 0, lendiff, base)
            svtype = np.full(L, "", dtype=object)
            for kind, st in (
                ("deletion", "DEL"), ("insertion", "INS"),
                ("inversion", "INV"), ("duplication", "DUP"),
            ):
                svtype[kinds == kind] = st
            extra = np.full(L, "", dtype=object)
            ssv = (
                ";SVLEN=" + obj(np.char.mod("%d", svlen))
                + ";SVTYPE=" + svtype
            )
            end_mask = np.isin(kinds, ("inversion", "duplication")) & (
                svlen_in != 0
            )
            if end_mask.any():
                pos_arr = np.array(
                    [v.pos for v in cb.variants], dtype=np.int64
                )
                ssv = np.where(
                    end_mask,
                    ssv + (";END=" + obj(np.char.mod("%d", pos_arr + svlen_in))),
                    ssv,
                )
            extra[sv_mask] = ssv[sv_mask]
            info = info + extra

        # rare per-locus INFO (imprecise / haplotype / aux) — Python only
        # on the rows that need it
        rare_rows = [
            li
            for li, v in enumerate(cb.variants)
            if (not v.precise and v.cipos is not None)
            or v.haplotype
            or getattr(v, "aux_info", None)
        ]
        for li in rare_rows:
            v = cb.variants[li]
            bits = []
            if not v.precise and v.cipos is not None:
                bits.append("IMPRECISE")
                bits.append(f"CIPOS={v.cipos[0]},{v.cipos[1]}")
                if v.ciend is not None:
                    bits.append(f"CIEND={v.ciend[0]},{v.ciend[1]}")
            if v.haplotype:
                if v.haplotype.startswith("event:"):
                    bits.append("EVENT=" + v.haplotype[len("event:"):])
                elif v.haplotype.startswith("mates:"):
                    bits.append(
                        "EVENT="
                        + "-".join(v.haplotype[len("mates:"):].split(","))
                    )
            if bits:
                info[li] = info[li] + ";" + ";".join(bits)

        # ---- HINTS (8 combos, lookup table)
        hcode = (
            cb.hint_filtered.astype(np.int64)
            + 2 * cb.hint_singleton.astype(np.int64)
            + 4 * missing.astype(np.int64)
        )
        if hcode.any():
            names3 = (
                "filtered-non-standard-alignments",
                "adjusted-singleton-evidence",
                "missing-data",
            )
            tbl = np.array(
                [
                    (
                        ";HINTS=" + ",".join(
                            n for b, n in enumerate(names3) if c & (1 << b)
                        )
                        if c
                        else ""
                    )
                    for c in range(8)
                ],
                dtype=object,
            )
            info = info + tbl[hcode]

        # aux INFO passthrough (rare; setdefault semantics — only keys not
        # already written)
        for li in rare_rows:
            v = cb.variants[li]
            aux = getattr(v, "aux_info", None)
            if not aux:
                continue
            cur = info[li]
            written = {kv.split("=", 1)[0] for kv in cur.split(";")}
            bits = []
            for k2, val in aux.items():
                if k2 in written:
                    continue
                if val is True:
                    bits.append(k2)
                elif isinstance(val, (list, tuple)):
                    bits.append(f"{k2}={','.join(str(x) for x in val)}")
                else:
                    bits.append(f"{k2}={val}")
            if bits:
                info[li] = cur + ";" + ";".join(bits)

        # ---- FORMAT sample columns
        fmt_str = ":".join(_FORMAT_KEYS)
        missing_sample = ":".join(["."] * len(_FORMAT_KEYS))
        mid_tbl = np.array(
            [
                ":".join(
                    c.short_labels()[k]
                    for k in ("SB", "ROB", "RPB", "SCB", "HE", "ALB")
                )
                for c in FULL_COMBOS
            ],
            dtype=object,
        )
        mid = mid_tbl[np.where(is_artifact, p["map_combo_idx"], 0)]
        sample_cols = []
        for si in range(S):
            dp_s = _int_strings(p["dp"][:, si])
            af_col = np.where(is_artifact, 0.0, p["af"][:, si])
            af_s = obj(np.char.mod("%.4f", af_col))
            oobs_s = _int_strings(cb.n_filtered[:, si].astype(np.int64))
            # *_strs are flat lists indexed li*S+si -> stride-slice per sample
            obs_sl = obj(p["obs_strs"][si::S])
            sa_sl = obj(p["saobs_strs"][si::S])
            sr_sl = obj(p["srobs_strs"][si::S])
            afd_sl = obj(p["afd_strs"][si::S])
            col = (
                dp_s + (":" + af_s)
                + ((":" + obs_sl) + (":" + sa_sl))
                + ((":" + sr_sl) + (":" + oobs_s))
                + ((":" + mid) + (":" + afd_sl))
            )
            if any_missing:
                col[missing] = missing_sample
            sample_cols.append(col)

        # ---- line assembly (single contig per window)
        chrom = cb.variants[0].chrom
        pos1 = obj(
            np.char.mod(
                "%d",
                np.array([v.pos for v in cb.variants], dtype=np.int64) + 1,
            )
        )
        ref = obj([v.ref_allele for v in cb.variants])
        alt = obj([v.alt_allele for v in cb.variants])
        head = chrom + "\t"
        tail = "\t.\t.\t"
        lines = (
            (head + pos1)
            + (("\t.\t" + ref) + ("\t" + alt))
            + ((tail + info) + ("\t" + fmt_str))
        )
        for col in sample_cols:
            lines = lines + ("\t" + col)
        lines = lines + "\n"
        return "".join(lines.tolist())

    # ------------------------------------------------------------------
    def _afd_strings(self, dphred, grid, is_artifact):
        """[L*S] AFD strings 'vaf=phred,...' from the deci-PHRED panel
        (vectorized: one nonzero scan + one fused string-add over every
        shipped point in the window, then a per-row slice join)."""
        L, S, G = dphred.shape
        gcache = getattr(self, "_grid_str_cache", None)
        if gcache is None or gcache[0] is not grid:
            prefixes = np.array(
                [
                    np.format_float_positional(
                        np.float32(vaf), unique=True, trim="-"
                    )
                    + "="
                    for vaf in grid.values
                ],
                dtype=object,
            )
            gcache = self._grid_str_cache = (grid, prefixes)
        prefixes = gcache[1]
        tbl = _PhredStrings.table_np()
        flat = dphred.reshape(L * S, G)
        keep = flat != 32767
        keep[np.repeat(is_artifact, S)] = False
        rows, cols = np.nonzero(keep)
        pieces = (prefixes[cols] + tbl[flat[rows, cols]]).tolist()
        bounds = np.searchsorted(rows, np.arange(L * S + 1))
        join = ",".join
        return [
            join(pieces[bounds[r] : bounds[r + 1]])
            if bounds[r + 1] > bounds[r]
            else "."
            for r in range(L * S)
        ]

    # ------------------------------------------------------------------
    def _obs_codes(self, cb: ColumnarBatch):
        """Integer-coded per-obs OBS-string fields (call._obs_string fmt)."""
        pa = cb.pa_fmt.astype(np.float64)
        pr = cb.pr_fmt.astype(np.float64)
        d = pa - pr
        with np.errstate(over="ignore"):
            bf = np.where(d > 700, np.inf, np.exp(np.abs(d)))
        level = np.searchsorted(
            np.array([1.0, 3.2, 10.0, 100.0]), bf, side="left"
        )
        # exact-equality ties are level "E" (bf == 1.0)
        side = np.where(d > 0, 0, np.where(d < 0, 1, 2))  # A / R / E
        flags = cb.u8[:, CU_FLAGS]
        upper = (flags & FLAG_IS_MAX_MAPQ) != 0
        third = cb.third.astype(np.int64)  # -1 = None
        paired = (flags & FLAG_PAIRED) != 0
        alt_locus = cb.u8[:, CU_ALT_LOCUS].astype(np.int64)
        strand = cb.u8[:, CU_STRAND].astype(np.int64)
        ro = cb.u8[:, CU_RO].astype(np.int64)
        from ..ops.compact_obs import FLAG_READ_POSITION_MAJOR

        rp_major = (flags & FLAG_READ_POSITION_MAJOR) != 0
        sc = (flags & FLAG_SOFTCLIPPED) != 0
        hil = cb.hil.astype(np.int64)
        he = (hil != HOMOPOLYMER_NONE) & (hil != 0)
        code = side * 8 + level
        code = code * 2 + upper
        code = code * 32770 + (third + 1)  # third in [-1, 32767]
        code = code * 2 + paired
        code = code * 4 + alt_locus
        code = code * 4 + strand
        code = code * 16 + ro
        code = code * 2 + rp_major
        code = code * 2 + sc
        code = code * 2 + he
        return code.astype(np.int64)

    @staticmethod
    def _decode_obs_code(code):
        he = code % 2; code //= 2
        sc = code % 2; code //= 2
        rp = code % 2; code //= 2
        ro = code % 16; code //= 16
        strand = code % 4; code //= 4
        alt_locus = code % 4; code //= 4
        paired = code % 2; code //= 2
        third = code % 32770 - 1; code //= 32770
        upper = code % 2; code //= 2
        level = code % 8; code //= 8
        side = code
        if side == 2:
            score = "E"
        else:
            letter = _KR_LETTERS[min(level, 4)]
            score = ("A" if side == 0 else "R") + letter
        score = score.upper() if upper else score.lower()
        third_s = str(third) if third >= 0 else "."
        paired_s = "p" if paired else "s"
        al_s = {ALT_LOCUS_MAJOR: "#", ALT_LOCUS_SOME: "*"}.get(alt_locus, ".")
        st_s = {
            STRAND_BOTH: "*",
            STRAND_REVERSE: "-",
            STRAND_FORWARD: "+",
        }.get(strand, ".")
        ro_s = {RO_F1R2: ">", RO_F2R1: "<", RO_NONE: "*"}.get(ro, "!")
        rp_s = "^" if rp else "*"
        sc_s = "$" if sc else "."
        he_s = "*" if he else "."
        return f"{score}{third_s}{paired_s}{al_s}{st_s}{ro_s}{rp_s}{sc_s}{he_s}"

    def _obs_strings(self, cb: ColumnarBatch):
        """[L*S] FORMAT OBS generalized-CIGAR strings, built by integer
        code counting (np.unique) instead of per-read Counters."""
        ls, _ = cb._seg_ids()
        codes = self._obs_codes(cb)
        cache = self._obs_code_cache = getattr(self, "_obs_code_cache", {})

        def decode(c):
            s = cache.get(c)
            if s is None:
                s = cache[c] = self._decode_obs_code(int(c))
            return s

        def aux(s):
            return 2 if s.startswith("N") else (1 if s.startswith("E") else 0)

        return _generalized_cigar_groups(
            ls, codes, cb.L * cb.S, decode, aux
        )

    def _simple_obs_strings(self, cb: ColumnarBatch, alt: bool):
        """[L*S] FORMAT SAOBS/SROBS strings."""
        ls, _ = cb._seg_ids()
        pa = cb.pa_fmt.astype(np.float64)
        pr = cb.pr_fmt.astype(np.float64)
        keep = (pa > pr) if alt else (pa <= pr)
        d = (pa - pr) if alt else (pr - pa)
        with np.errstate(over="ignore"):
            bf = np.where(pa == pr, 1.0, np.where(d > 700, np.inf, np.exp(d)))
        level = np.searchsorted(
            np.array([1.0, 3.2, 10.0, 100.0]), bf, side="left"
        )
        is_exact_one = np.abs(bf - 1.0) < 1e-9
        upper = (cb.u8[:, CU_FLAGS] & FLAG_IS_MAX_MAPQ) != 0
        code = (level * 2 + is_exact_one) * 2 + upper

        def decode(c):
            c = int(c)
            up = c % 2
            c //= 2
            exact1 = c % 2
            lvl = c // 2
            if lvl == 0:
                letter = "E" if exact1 else "N"
            else:
                letter = _KR_LETTERS[min(lvl, 4)]
            return letter if up else letter.lower()

        def aux(s):
            return 2 if s.startswith("R") else (1 if s.endswith("E") else 0)

        return _generalized_cigar_groups(
            ls[keep], code[keep].astype(np.int64), cb.L * cb.S, decode, aux
        )


def _generalized_cigar_groups(ls, codes, n_groups, decode, aux_sort):
    """Per-(locus,sample) generalized-CIGAR strings from integer item codes.

    Reproduces call._generalized_cigar's ordering: Counter.most_common
    (count desc, first-occurrence order on ties) re-sorted stably by
    (aux_sort(item), -count)."""
    if len(ls) == 0:
        return ["."] * n_groups
    key = ls * (1 << 40) + codes  # codes < 2^40 by construction
    uniq, first_idx, counts = np.unique(
        key, return_index=True, return_counts=True
    )
    u_ls = (uniq >> 40).astype(np.int64)
    u_code = uniq & ((1 << 40) - 1)
    # decode each distinct code once (cross-window cache in `decode`),
    # then broadcast to rows by a searchsorted gather (no per-row Python)
    code_uniq = np.unique(u_code)
    dec_uniq = np.array([decode(c) for c in code_uniq], dtype=object)
    aux_uniq = np.fromiter(
        (aux_sort(s) for s in dec_uniq), dtype=np.int64, count=len(dec_uniq)
    )
    row_ci = np.searchsorted(code_uniq, u_code)
    aux_vals = aux_uniq[row_ci]
    # the object path's three stable sorts (first-occurrence, then -count,
    # then (aux, -count)) collapse to one composite key
    order = np.lexsort((first_idx, -counts, aux_vals, u_ls))
    out = ["."] * n_groups
    u_ls_o = u_ls[order]
    counts_o = counts[order]
    # interleave vectorized count strings with decoded code strings; each
    # group's string is one join over its slice
    parts = np.empty(2 * len(order), dtype=object)
    parts[0::2] = _int_strings(counts_o)
    parts[1::2] = dec_uniq[row_ci[order]]
    parts_l = parts.tolist()
    bounds = np.searchsorted(u_ls_o, np.arange(n_groups + 1))
    join = "".join
    for g in range(n_groups):
        a, b = bounds[g], bounds[g + 1]
        if a == b:
            continue
        out[g] = join(parts_l[2 * a : 2 * b])
    return out


def _variant_info_fields(v, info):
    """SVLEN/SVTYPE/END/IMPRECISE/CIPOS/CIEND/EVENT INFO (shared with the
    object path's _result_to_record)."""
    if v.kind in ("deletion", "insertion", "inversion", "duplication"):
        info["SVLEN"] = (
            -v.svlen if v.kind == "deletion" else v.svlen
        ) or len(v.alt_allele) - len(v.ref_allele)
        info["SVTYPE"] = {
            "deletion": "DEL",
            "insertion": "INS",
            "inversion": "INV",
            "duplication": "DUP",
        }[v.kind]
        if v.kind in ("inversion", "duplication") and v.svlen:
            info["END"] = v.pos + v.svlen
    if not v.precise and v.cipos is not None:
        info["IMPRECISE"] = True
        info["CIPOS"] = f"{v.cipos[0]},{v.cipos[1]}"
        if v.ciend is not None:
            info["CIEND"] = f"{v.ciend[0]},{v.ciend[1]}"
    if v.haplotype:
        if v.haplotype.startswith("event:"):
            info["EVENT"] = v.haplotype[len("event:"):]
        elif v.haplotype.startswith("mates:"):
            info["EVENT"] = "-".join(v.haplotype[len("mates:"):].split(","))
