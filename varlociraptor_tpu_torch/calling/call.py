"""Calling pipeline: N observation files -> posterior calls VCF (torch port).

Counterpart of ``varlociraptor_tpu/calling/call.py``: lockstep reading of
per-sample observation files, the engine per (contig, event set), and two
paths to it.  The columnar path (``fastcall.ColumnarCaller``) dispatches
windows to the device ahead of a drain thread that fetches, formats and
writes earlier ones.  The legacy per-WorkItem path (``GenericCaller
.call_batch`` through ``PosteriorEngine.run``) serves the plug-in hooks that
need Pileup objects (``call_processor``, ``candidate_filter``: contamination
estimation) and ``VLT_LEGACY_CALL=1``.  Observation files without columnar
windows (the reference's v15 BCF/VCF) are read record by record on either
path.  With a device mesh (``parallel.sharding.LocusMesh``) both paths split
each engine batch over the mesh's shards.
"""

from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..evidence.observation import (
    ObservationBatch,
    Pileup,
    adjust_singleton_evidence,
    expected_depth,
)
from ..grammar.compiler import compile_scenario_events
from ..grammar.scenario import Scenario
from ..io.vcf import VcfRecord, VcfWriter, open_variant_writer
from ..ops.biases import (
    ALB_NONE,
    BiasCombo,
    HE_NONE,
    ROB_NONE,
    RPB_NONE,
    SB_NONE,
    SCB_NONE,
    build_bias_tensor,
    compact_combos,
)
from ..ops.grid import AFGrid
from ..ops.prior import build_prior
from ..ops.prior_table import joint_prior_table
from ..utils.logprob import np_ln_sum_exp, np_log_from_phred, np_phred_from_log

from .. import tracing
from ..device import resolve_device
from ..ops.biases import FULL_COMBOS_DEFAULT as FULL_COMBOS
from ..ops.posterior import PosteriorEngine, SampleConfig
from .ref_obs import open_observations
from .variants import VariantInfo

# loci per batch of the legacy per-WorkItem path (its locus axis is padded
# to this size) and per window of the columnar path
DEFAULT_BATCH = 64
DEFAULT_COLUMNAR_BATCH = 1024


@dataclass
class CallOptions:
    omit_strand_bias: bool = False
    omit_read_orientation_bias: bool = False
    omit_read_position_bias: bool = False
    omit_softclip_bias: bool = False
    omit_homopolymer_artifact_detection: bool = False
    omit_alt_locus_bias: bool = False
    full_prior: bool = False
    batch_size: int | None = None  # None = path-dependent default
    resolution: float = 0.01

    def effective_batch(self, columnar: bool) -> int:
        if self.batch_size is not None:
            return self.batch_size
        return DEFAULT_COLUMNAR_BATCH if columnar else DEFAULT_BATCH


@dataclass
class WorkItem:
    index: int
    variant: VariantInfo
    pileups: list
    flags: tuple  # per-dimension consider flags
    snv: tuple | None  # (refbase, altbase) chars
    hints: list = field(default_factory=list)


# process-global engine cache keyed by configuration content and device, so
# repeated call_generic invocations reuse engines and their device tables
_GLOBAL_ENGINES: dict = {}


def _engine_content_key(events, grid, sample_configs, resolution,
                        all_uniform, vaf_mask, device):
    try:
        return (
            tuple(events),
            grid.values.tobytes(),
            tuple(
                (s.name, s.contaminated_by, s.contamination_fraction,
                 s.resolution)
                for s in sample_configs
            ),
            resolution,
            bool(all_uniform),
            None if vaf_mask is None else np.asarray(vaf_mask).tobytes(),
            str(device),
        )
    except TypeError:  # unhashable event payload: fall back to per-caller
        return None


def _combo_allowed(combo: BiasCombo, flags) -> bool:
    (c_ro, c_sb, c_rp, c_sc, c_he, c_al) = flags
    if combo.strand != SB_NONE and not c_sb:
        return False
    if combo.read_orientation != ROB_NONE and not c_ro:
        return False
    if combo.read_position != RPB_NONE and not c_rp:
        return False
    if combo.softclip != SCB_NONE and not c_sc:
        return False
    if combo.homopolymer != HE_NONE and not c_he:
        return False
    if combo.alt_locus != ALB_NONE and not c_al:
        return False
    return True


class GenericCaller:
    def __init__(
        self,
        scenario: Scenario,
        options: CallOptions | None = None,
        device="cuda",
        mesh=None,
    ):
        self.scenario = scenario
        self.options = options or CallOptions()
        self.device = resolve_device(device)
        # device mesh for locus-data-parallel engine evaluation
        self.mesh = mesh
        self._engines = {}
        self._events_cache = {}
        self._prior_cache = {}
        # --full-prior: host tables by what they depend on, and per engine
        # the rows uploaded to its device (_joint_prior_row)
        self._full_prior_tables = {}
        self._prior_rows = {}

        self.sample_configs = []
        for name in scenario.sample_names:
            s = scenario.samples[name]
            if s.contamination is not None:
                self.sample_configs.append(
                    SampleConfig(
                        name,
                        contaminated_by=scenario.idx(s.contamination.by),
                        contamination_fraction=s.contamination.fraction,
                        resolution=s.resolution,
                    )
                )
            else:
                self.sample_configs.append(
                    SampleConfig(name, resolution=s.resolution)
                )

    # ------------------------------------------------------------------
    def _events_for(self, contig):
        if contig not in self._events_cache:
            events, grid_points = compile_scenario_events(self.scenario, contig)
            grid = AFGrid.build(self.options.resolution, extra_points=grid_points)
            self._events_cache[contig] = (events, grid)
        return self._events_cache[contig]

    def _prior_for(self, contig, vartype):
        key = (contig, vartype)
        if key not in self._prior_cache:
            from ..ops.prior import check_prior

            prior = build_prior(self.scenario, contig, vartype)
            check_prior(prior)
            self._prior_cache[key] = prior
        return self._prior_cache[key]

    def _engine_for(self, contig, events, grid):
        key = (contig, id(events))
        if key not in self._engines:
            # zero structure of the prior on this contig (ploidy-0 sex
            # contigs, uniform universes, germline lattice)
            prior = self._prior_for(contig, "snv")
            all_uniform = all(
                self.scenario.samples[n].has_uniform_prior()
                for n in self.scenario.sample_names
            )
            vaf_mask = prior.valid_vaf_mask(grid.values)
            gkey = _engine_content_key(
                events, grid, self.sample_configs, self.options.resolution,
                all_uniform, vaf_mask, self.device,
            )
            eng = _GLOBAL_ENGINES.get(gkey) if gkey is not None else None
            if eng is None:
                eng = PosteriorEngine(
                    events,
                    grid,
                    self.sample_configs,
                    resolution=self.options.resolution,
                    n_artifact_combos=max(1, len(FULL_COMBOS) - 1),
                    all_uniform_prior=all_uniform,
                    valid_vaf_mask=vaf_mask,
                    device=self.device,
                )
                if gkey is not None:
                    if len(_GLOBAL_ENGINES) >= 8:
                        _GLOBAL_ENGINES.pop(next(iter(_GLOBAL_ENGINES)))
                    _GLOBAL_ENGINES[gkey] = eng
            self._engines[key] = eng
        return self._engines[key]

    # ------------------------------------------------------------------
    def make_work_item(self, index, variant: VariantInfo, pileups: list) -> WorkItem:
        o = self.options
        is_snv_or_mnv = len(variant.ref_allele) == len(variant.alt_allele)
        precise = variant.precise
        has_homopolymer = any(
            obs.homopolymer_indel_len is not None
            for p in pileups
            for obs in p.read_observations
        )
        flags = (
            is_snv_or_mnv and not o.omit_read_orientation_bias and precise,  # ro
            not o.omit_strand_bias and precise,  # sb
            is_snv_or_mnv and not o.omit_read_position_bias and precise,  # rp
            is_snv_or_mnv and not o.omit_softclip_bias and precise,  # sc
            has_homopolymer and not o.omit_homopolymer_artifact_detection,  # he
            not o.omit_alt_locus_bias,  # al
        )
        hints = []
        if is_snv_or_mnv:
            filtered = False
            for p in pileups:
                filtered |= bool(
                    p.remove_nonstandard_alignments(o.omit_read_orientation_bias)
                )
            if filtered:
                hints.append("filtered-non-standard-alignments")
        if adjust_singleton_evidence(pileups):
            hints.append("adjusted-singleton-evidence")
        snv = None
        if len(variant.ref_allele) == 1 and len(variant.alt_allele) == 1 and variant.kind == "snv":
            snv = (variant.ref_allele.upper(), variant.alt_allele.upper())
        return WorkItem(
            index=index,
            variant=variant,
            pileups=pileups,
            flags=flags,
            snv=snv,
            hints=hints,
        )

    def _full_prior_table(self, variant, prior, value_lists):
        """(key, table): the joint prior for --full-prior on the engine's
        per-sample active subgrids (the axes the engine integrates), float32,
        computed over the whole grid at once (``ops/prior_table.py``) in the
        span ``call.prior_table`` (counter ``prior.table_cells``).  Cached by
        what it depends on: the samples' ploidies and universes on the
        contig, the variant type, the candidate's HETEROZYGOSITY /
        SOMATIC_EFFECTIVE_MUTATION_RATE INFO overrides (prior.rs:251-271,
        already set on ``prior``) and the grid."""
        key = (
            tuple(prior.ploidies),
            repr(prior.universes),
            variant.kind,
            variant.heterozygosity,
            variant.somatic_effective_mutation_rate,
            tuple(np.asarray(v, dtype=np.float64).tobytes() for v in value_lists),
        )
        hit = self._full_prior_tables.get(key)
        if hit is not None:
            return key, hit
        shapes = tuple(len(v) for v in value_lists)
        size = int(np.prod(shapes))
        if size > 2_000_000:
            from ..errors import InvalidPriorConfigurationError

            raise InvalidPriorConfigurationError(
                f"--full-prior joint grid has {size} cells over "
                f"{len(value_lists)} samples; coarsen per-sample "
                "`resolution:` in the scenario"
            )
        with tracing.span("call.prior_table"):
            table = joint_prior_table(prior, value_lists).astype(np.float32)
            tracing.count("prior.table_cells", table.size)
        self._full_prior_tables[key] = table
        return key, table

    def _joint_prior_row(self, engine, variant, prior):
        """--full-prior: the row of ``variant``'s joint prior table among
        the tables of ``engine`` (``prior`` carries its overrides)."""
        key, table = self._full_prior_table(variant, prior, engine.values_s)
        rows = self._prior_rows.setdefault(id(engine), {"rows": {}, "device": None})
        row = rows["rows"].get(key)
        if row is None:
            row = rows["rows"][key] = len(rows["rows"])
            rows["device"] = None
        return row

    def _joint_prior_tables(self, engine):
        """The tables of ``engine``'s rows on its device [K, G_0, ...,
        G_{S-1}]: uploaded once, and again only when a new key adds a row."""
        rows = self._prior_rows[id(engine)]
        if rows["device"] is None:
            host = [self._full_prior_tables[k] for k in rows["rows"]]
            rows["device"] = engine.upload_prior_tables(np.stack(host))
        return rows["device"]

    def call_batch(self, items: list[WorkItem], contig: str):
        """Evaluate a batch of work items (same contig) through
        ``PosteriorEngine.run`` on the caller's device.  Returns list of
        per-item result dicts."""
        events, grid = self._events_for(contig)
        engine = self._engine_for(contig, events, grid)
        L = len(items)
        S = len(self.scenario.sample_names)
        depth = max(
            (len(p.read_observations) for it in items for p in it.pileups),
            default=1,
        )
        depth = max(1, 1 << (max(depth, 1) - 1).bit_length())  # pow2 bucket

        batch = ObservationBatch.collate([it.pileups for it in items], depth=depth)
        B = len(FULL_COMBOS)
        bias_alt = np.zeros((L, S, B, depth), dtype=np.float32)
        bias_ref = np.zeros((L, S, B, depth), dtype=np.float32)
        bias_any = np.zeros((L, S, B, depth), dtype=np.float32)
        combo_active = np.zeros((L, B), dtype=bool)
        # per-locus artifact-combo count: the 0.5 artifact prior is split
        # over the combos CONSIDERED at each locus (event.biases.len(),
        # generic.rs:437-441) - i.e. the variant-class/pileup check_* flags,
        # before the is_possible/is_informative gating
        n_artifact_active = np.ones(L, dtype=np.float32)
        for li, it in enumerate(items):
            allowed = np.array(
                [_combo_allowed(c, it.flags) for c in FULL_COMBOS]
            )
            bt = build_bias_tensor(it.pileups, FULL_COMBOS, depth, allowed=allowed)
            bias_alt[li] = bt.alt
            bias_ref[li] = bt.ref
            bias_any[li] = bt.any
            combo_active[li] = bt.active & allowed
            combo_active[li, 0] = True  # no-artifact always active
            n_artifact_active[li] = max(1, int(allowed[1:].sum()))

        # compact the combo axis: most loci activate 1-3 of the ~9 combos
        bias_alt, bias_ref, bias_any, combo_active, slot_map = compact_combos(
            bias_alt, bias_ref, bias_any, combo_active
        )

        branch_gates = np.ones((L, engine.n_branches), dtype=bool)
        for li, it in enumerate(items):
            for bi, (ei, br) in enumerate(engine.branches):
                branch_gates[li, bi] = br.passes_snv(it.snv)

        ln_prior_absent = np.zeros(L, dtype=np.float32)
        prior_rows = np.zeros(L, dtype=np.int32) if self.options.full_prior else None
        for li, it in enumerate(items):
            prior = self._prior_for(contig, it.variant.kind)
            # per-variant INFO overrides (prior.rs:251-271); reset first —
            # the Prior is shared per (contig, vartype), so a previous
            # record's override must not leak into override-free records
            prior.variant_heterozygosity = it.variant.heterozygosity
            prior.variant_somatic_rate = (
                it.variant.somatic_effective_mutation_rate
            )
            ln_prior_absent[li] = prior.prob_absent()
            if prior_rows is not None:
                prior_rows[li] = self._joint_prior_row(engine, it.variant, prior)
        ln_prior_joint = (
            None if prior_rows is None else self._joint_prior_tables(engine)
        )

        # pad the locus axis to the fixed batch size, so that every batch
        # gives the engine (and K1) the same shapes (padded loci carry empty
        # pileups and their results are dropped below)
        Lp = self.options.effective_batch(columnar=False)
        feats, mask = batch.features, batch.mask
        if L < Lp:
            def _pad(a):
                return np.concatenate(
                    [a, np.zeros((Lp - L,) + a.shape[1:], dtype=a.dtype)], axis=0
                )

            feats = _pad(np.asarray(feats))
            mask = _pad(np.asarray(mask))
            bias_alt = _pad(bias_alt)
            bias_ref = _pad(bias_ref)
            bias_any = _pad(bias_any)
            combo_active = _pad(combo_active)
            combo_active[L:, 0] = True
            branch_gates = np.concatenate(
                [
                    branch_gates,
                    np.ones((Lp - L, engine.n_branches), dtype=bool),
                ],
                axis=0,
            )
            ln_prior_absent = _pad(ln_prior_absent)
            n_artifact_active = np.concatenate(
                [n_artifact_active, np.ones(Lp - L, dtype=np.float32)]
            )
            if prior_rows is not None:
                prior_rows = _pad(prior_rows)

        if self.mesh is not None and ln_prior_joint is None:
            from ..parallel.sharding import run_sharded

            out = run_sharded(
                engine, self.mesh, feats, mask, bias_alt, bias_ref,
                bias_any, combo_active, branch_gates, ln_prior_absent,
                n_artifact_active=n_artifact_active,
            )
        else:
            out = engine.run(
                feats,
                mask,
                bias_alt,
                bias_ref,
                bias_any,
                combo_active,
                branch_gates,
                ln_prior_absent,
                ln_prior_joint=ln_prior_joint,
                n_artifact_active=n_artifact_active,
                ln_prior_idx=prior_rows,
            )
        if L < Lp:
            out = {
                k: (v[:L] if hasattr(v, "shape") and v.shape[:1] == (Lp,) else v)
                for k, v in out.items()
            }

        results = []
        for li, it in enumerate(items):
            post = out["posteriors"][li]  # [E]
            event_probs = {}
            artifact_terms = []
            for ei, ev in enumerate(events):
                if ev.is_artifact:
                    artifact_terms.append(post[ei])
                else:
                    event_probs[ev.name] = post[ei]
            prob_artifact = (
                np_ln_sum_exp(np.array(artifact_terms))
                if artifact_terms
                else -np.inf
            )
            event_probs["artifact"] = prob_artifact
            best = max(event_probs.items(), key=lambda kv: kv[1])[0]
            is_artifact = best == "artifact"

            sample_infos = []
            if is_artifact:
                map_slot = int(out["map_slot"][li])
                map_combo = FULL_COMBOS[int(slot_map[li, map_slot])]
            else:
                map_combo = FULL_COMBOS[0]
            for si in range(S):
                pileup = it.pileups[si]
                if is_artifact:
                    af = 0.0
                    afd = None
                else:
                    # MAP AF from the engine; the AFD arrives as
                    # marginal-normalized deci-PHRED int16 (32767 = -inf)
                    af = float(out["af"][li, si])
                    dphred = out["densities_dphred"][li, si]
                    afd = {
                        float(g): float(np_log_from_phred(v / 10.0))
                        for g, v in zip(grid.values, dphred)
                        if v != 32767
                    }
                sample_infos.append(
                    {
                        "af": af,
                        "afd": afd,
                        "dp": expected_depth(pileup.read_observations),
                        "pileup": pileup,
                        "artifacts": map_combo.short_labels(),
                    }
                )
            # missing-data: no sample has any observation covering the
            # candidate — the reference emits HINTS=missing-data, missing
            # PROB_* values and no FORMAT fields instead of a prior-only
            # posterior (calling/variants/mod.rs:424-451,469)
            hints = list(it.hints)
            if all(not p.read_observations for p in it.pileups):
                hints.append("missing-data")
            results.append(
                {
                    "variant": it.variant,
                    "event_probs": event_probs,
                    "sample_infos": sample_infos,
                    "hints": hints,
                }
            )
        return results


@tracing.traced("call.generic")
def call_generic(
    scenario: Scenario,
    observation_paths: dict,
    output_path,
    options: CallOptions | None = None,
    call_processor=None,
    mesh=None,
    candidate_filter=None,
    device="cuda",
):
    """Full calling pipeline (cli.rs call_generic equivalent).

    observation_paths: {sample_name: path}, must cover scenario samples.
    ``call_processor``: optional callable that receives each result dict of
    the legacy path after its record is written.  ``candidate_filter``:
    optional WorkItem predicate — items returning False are skipped entirely
    (the reference's CandidateFilter plug-in trait, calling.rs:964-1020; used
    by contamination estimation).  Either hook, or ``VLT_LEGACY_CALL=1``,
    selects the legacy per-WorkItem path.  ``device``: where the posterior
    engine is built ("cuda" or "cpu").  ``mesh``: optional
    ``parallel.sharding.LocusMesh`` for locus-data-parallel engine
    evaluation (a multi-process mesh: this process's own loci).  Returns
    number of records called."""
    options = options or CallOptions()
    if not any(name in observation_paths for name in scenario.sample_names):
        raise ValueError("no observation files given")
    use_columnar = (
        call_processor is None
        and candidate_filter is None
        and os.environ.get("VLT_LEGACY_CALL") != "1"
    )
    if use_columnar:
        from .fastcall import ColumnarCaller

        caller = ColumnarCaller(scenario, options, device=device, mesh=mesh)
    else:
        caller = GenericCaller(scenario, options, device=device, mesh=mesh)

    sample_names = scenario.sample_names
    event_names = [n for n in scenario.event_formulas.keys() if n != "absent"]
    header = [
        '##INFO=<ID=SVLEN,Number=A,Type=Integer,Description="SV length">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="SV end">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">',
        '##INFO=<ID=EVENT,Number=1,Type=String,Description="Haplotype event identifier">',
        '##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise structural variant">',
        '##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS">',
        '##INFO=<ID=CIEND,Number=2,Type=Integer,Description="Confidence interval around END">',
        '##INFO=<ID=HINTS,Number=.,Type=String,Description="Model hints">',
        '##INFO=<ID=PROB_ABSENT,Number=A,Type=Float,Description="PHRED posterior">',
        '##INFO=<ID=PROB_ARTIFACT,Number=A,Type=Float,Description="PHRED posterior">',
    ] + [
        f'##INFO=<ID=PROB_{n.upper()},Number=A,Type=Float,Description="PHRED posterior for event {n}">'
        for n in event_names
    ] + [
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Expected depth">',
        '##FORMAT=<ID=AF,Number=1,Type=Float,Description="MAP allele frequency">',
        '##FORMAT=<ID=OBS,Number=1,Type=String,Description="Summarized observations">',
        '##FORMAT=<ID=SAOBS,Number=1,Type=String,Description="Simplified alt observations">',
        '##FORMAT=<ID=SROBS,Number=1,Type=String,Description="Simplified ref observations">',
        '##FORMAT=<ID=OOBS,Number=1,Type=Integer,Description="Omitted observations">',
        '##FORMAT=<ID=SB,Number=1,Type=String,Description="Strand bias MAP indicator">',
        '##FORMAT=<ID=ROB,Number=1,Type=String,Description="Read orientation bias MAP indicator">',
        '##FORMAT=<ID=RPB,Number=1,Type=String,Description="Read position bias MAP indicator">',
        '##FORMAT=<ID=SCB,Number=1,Type=String,Description="Softclip bias MAP indicator">',
        '##FORMAT=<ID=HE,Number=1,Type=String,Description="Homopolymer error MAP indicator">',
        '##FORMAT=<ID=ALB,Number=1,Type=String,Description="Alt locus bias MAP indicator">',
        '##FORMAT=<ID=AFD,Number=1,Type=String,Description="VAF density (vaf=phred)">',
    ]

    readers = [
        open_observations(observation_paths[name], name)
        if name in observation_paths
        else None
        for name in scenario.sample_names
    ]
    try:
        with open_variant_writer(
            output_path, sample_names=sample_names, header_lines=header
        ) as w:
            # zero-object read path: when every present reader supports
            # columnar windows, records never materialize as per-read
            # Python objects at all
            if use_columnar and all(
                r is None or hasattr(r, "read_window") for r in readers
            ):
                return _call_windows(caller, readers, options, w, sample_names)
            return _call_records(
                caller, readers, options, w, sample_names, use_columnar,
                call_processor, candidate_filter,
            )
    finally:
        for r in readers:
            if r is not None:
                r.close()


class _Progress:
    """Periodic progress logging, mirroring the reference's 20-second
    progress_logger in the calling loop (calling.rs:349-352)."""

    def __init__(self):
        self.log = logging.getLogger("varlociraptor_tpu_torch.call")
        self.t0 = self.last = time.monotonic()

    def tick(self, n):
        now = time.monotonic()
        if now - self.last >= 20.0:
            self.log.info(
                "called %d records (%.0f records/s)",
                n, n / max(now - self.t0, 1e-9),
            )
            self.last = now


def _call_windows(caller, readers, options, w, sample_names):
    """The columnar path over readers with ``read_window``: windows go to the
    device ahead of a drain thread that fetches, formats and writes them."""
    from .columnar import ColumnarBatch

    window_n = options.effective_batch(columnar=True)
    progress = _Progress()
    text_ok = type(w) is VcfWriter  # vectorized text fast path
    # windows in flight on the device while the drain thread fetches, formats
    # and writes earlier ones (the bounded queue is the backpressure)
    depth_n = int(os.environ.get("VLT_DISPATCH_DEPTH", "4"))
    out_q: queue.Queue = queue.Queue(maxsize=max(depth_n, 1))
    state = {"n": 0, "err": None}

    @tracing.traced("call.drain")
    def drain_loop():
        for k in itertools.count():  # items arrive in window order: the k-th is window k
            with tracing.span("call.wait_main", k):
                item = out_q.get()
            if item is None:
                return
            if state["err"] is not None:
                continue  # drain remaining items after a failure
            cb_p, pw = item
            try:
                with tracing.span("engine.fetch", k):
                    out, meta = pw.finish()
                with tracing.span("call.format", k):
                    if text_ok:
                        w._fh.write(
                            caller.format_window_text(cb_p, out, meta, sample_names)
                        )
                        state["n"] += cb_p.L
                    else:
                        for rec in caller.format_window(cb_p, out, meta, sample_names):
                            w.write(rec)
                            state["n"] += 1
                progress.tick(state["n"])
            except BaseException as e:  # surfaced on the main thread
                state["err"] = e

    drainer = threading.Thread(target=drain_loop, name="vlt-drain")
    drainer.start()
    try:
        for wi in itertools.count():
            with tracing.span("call.read", wi):
                windows = [
                    r.read_window(window_n) if r is not None else None
                    for r in readers
                ]
                present = [x for x in windows if x is not None]
                if not present:
                    break
                lens = {len(x[0]) for x in present}
                if len(lens) != 1:
                    raise ValueError(
                        "inconsistent observation files (different lengths)"
                    )
                if lens == {0}:
                    break
                cb = ColumnarBatch.from_sample_windows(windows)
            with tracing.span("call.pack", wi):
                pw = caller.call_window_cb(cb, cb.variants[0].chrom, sync=False)
            tracing.count("call.windows", 1, wi)
            tracing.count("call.loci", cb.L, wi)
            with tracing.span("call.wait_drain", wi):
                out_q.put((cb, pw))
            if state["err"] is not None:
                break
    finally:
        with tracing.span("call.wait_drain"):
            out_q.put(None)
            drainer.join()
    if state["err"] is not None:
        raise state["err"]
    return state["n"]


def _call_records(caller, readers, options, w, sample_names, use_columnar,
                  call_processor, candidate_filter):
    """Record-by-record lockstep reading (every reader, the reference's v15
    files included), in batches of one contig: through the columnar caller
    (``ColumnarBatch.from_pileups``) or the legacy per-WorkItem caller
    (``make_work_item`` / ``call_batch`` / ``_result_to_record``, with the
    plug-in hooks)."""
    from .columnar import ColumnarBatch

    iters = [iter(r) if r is not None else None for r in readers]
    progress = _Progress()
    n = 0
    batch_items = []
    batch_contig = None

    def flush():
        nonlocal n
        if not batch_items:
            return
        if use_columnar:
            cb = ColumnarBatch.from_pileups(
                [it.variant for it in batch_items],
                [it.pileups for it in batch_items],
            )
            out, meta = caller.call_window_cb(cb, batch_contig)
            for rec in caller.format_window(cb, out, meta, sample_names):
                w.write(rec)
                n += 1
        else:
            for res in caller.call_batch(batch_items, batch_contig):
                w.write(_result_to_record(res, sample_names))
                if call_processor is not None:
                    call_processor(res)
                n += 1
        progress.tick(n)

    while True:
        recs = []
        done = 0
        n_present = 0
        for it in iters:
            if it is None:
                recs.append(None)
                continue
            n_present += 1
            try:
                recs.append(next(it))
            except StopIteration:
                recs.append(None)
                done += 1
        if done == n_present:
            break
        if done:
            raise ValueError("inconsistent observation files (different lengths)")
        variants = [v for r in recs if r is not None for v in [r[0]]]
        v0 = variants[0]
        for v in variants[1:]:
            if (v.chrom, v.pos, v.ref_allele, v.alt_allele) != (
                v0.chrom,
                v0.pos,
                v0.ref_allele,
                v0.alt_allele,
            ):
                raise ValueError("inconsistent observation files (different loci)")
        pileups = [r[1] if r is not None else Pileup() for r in recs]
        if use_columnar:
            # the columnar path applies the non-standard-alignment filter and
            # singleton adjustment vectorized in call_window_cb — don't
            # mutate the pileups here
            item = WorkItem(index=n, variant=v0, pileups=pileups, flags=(), snv=None)
        else:
            item = caller.make_work_item(n, v0, pileups)
            if candidate_filter is not None and not candidate_filter(item):
                continue
        if batch_contig is not None and (
            v0.chrom != batch_contig
            or len(batch_items) >= options.effective_batch(use_columnar)
        ):
            flush()
            batch_items = []
        batch_contig = v0.chrom
        batch_items.append(item)
    flush()
    return n


def _bf_letter(bf: float) -> str:
    """bayes_factor_to_letter (utils/mod.rs:158-167)."""
    from ..utils.logprob import (
        KR_BARELY,
        KR_NONE,
        KR_POSITIVE,
        KR_STRONG,
        kass_raftery,
    )

    level = kass_raftery(bf)
    if level == KR_BARELY:
        return "B"
    if level == KR_NONE:
        return "E" if abs(bf - 1.0) < 1e-9 else "N"
    if level == KR_POSITIVE:
        return "P"
    if level == KR_STRONG:
        return "S"
    return "V"


def _generalized_cigar(items, aux_sort):
    """utils/mod.rs:122-156 (unordered variant): count identical items,
    most-common-first then aux_sort."""
    from collections import Counter

    counts = Counter(items)
    ranked = sorted(
        counts.most_common(), key=lambda kv: (aux_sort(kv), -kv[1])
    )
    return "".join(f"{count}{item}" for item, count in ranked)


def _obs_string(pileup: Pileup) -> str:
    """FORMAT OBS: generalized-CIGAR observation audit strings
    (calling/variants/mod.rs:277-340)."""
    from ..evidence.observation import (
        ALT_LOCUS_MAJOR,
        ALT_LOCUS_SOME,
        READ_POSITION_MAJOR,
        RO_F1R2,
        RO_F2R1,
        RO_NONE,
        STRAND_BOTH,
        STRAND_FORWARD,
        STRAND_REVERSE,
    )

    def fmt(o):
        bf_alt = o.bayes_factor_alt()
        bf_ref = o.bayes_factor_ref()
        if bf_alt > bf_ref:
            score = "A" + _bf_letter(bf_alt)
        elif bf_ref > bf_alt:
            score = "R" + _bf_letter(bf_ref)
        else:
            score = "E"
        score = score.upper() if o.is_max_mapq else score.lower()
        third = str(o.third_allele_evidence) if o.third_allele_evidence is not None else "."
        paired = "p" if o.paired else "s"
        alt_locus = {ALT_LOCUS_MAJOR: "#", ALT_LOCUS_SOME: "*"}.get(o.alt_locus, ".")
        strand = {
            STRAND_BOTH: "*",
            STRAND_REVERSE: "-",
            STRAND_FORWARD: "+",
        }.get(o.strand, ".")
        ro = {RO_F1R2: ">", RO_F2R1: "<", RO_NONE: "*"}.get(o.read_orientation, "!")
        rp = "^" if o.read_position == READ_POSITION_MAJOR else "*"
        sc = "$" if o.softclipped else "."
        he = "*" if o.has_homopolymer_error() else "."
        return f"{score}{third}{paired}{alt_locus}{strand}{ro}{rp}{sc}{he}"

    if not pileup.read_observations:
        return "."
    return _generalized_cigar(
        (fmt(o) for o in pileup.read_observations),
        lambda kv: 2 if kv[0].startswith("N") else (1 if kv[0].startswith("E") else 0),
    )


def _simple_obs_string(pileup: Pileup, alt_allele: bool) -> str:
    """FORMAT SAOBS/SROBS (calling/variants/mod.rs:342-380)."""
    items = []
    for o in pileup.read_observations:
        bf = o.bayes_factor_alt() if alt_allele else o.bayes_factor_ref()
        keep = (
            (alt_allele and o.prob_alt > o.prob_ref)
            or (not alt_allele and o.prob_alt <= o.prob_ref)
        )
        if keep:
            letter = _bf_letter(bf)
            items.append(letter.upper() if o.is_max_mapq else letter.lower())
    if not items:
        return "."
    return _generalized_cigar(
        items,
        lambda kv: 2 if kv[0].startswith("R") else (1 if kv[0].endswith("E") else 0),
    )


_FORMAT_KEYS = (
    "DP", "AF", "OBS", "SAOBS", "SROBS", "OOBS",
    "SB", "ROB", "RPB", "SCB", "HE", "ALB", "AFD",
)


def _result_to_record(res, sample_names) -> VcfRecord:
    v: VariantInfo = res["variant"]
    info = {}
    missing_data = "missing-data" in res["hints"]
    for name, logp in sorted(res["event_probs"].items()):
        if missing_data:
            # missing PROB_* (f32::missing) — FDR's tags_prob_sum then
            # skips the record, matching utils/mod.rs:193-194
            info[f"PROB_{name.upper()}"] = "."
            continue
        phred = np_phred_from_log(logp)
        info[f"PROB_{name.upper()}"] = f"{phred:.4f}" if np.isfinite(phred) else "inf"
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
            # collect_variants requires END for INV/DUP (1-based inclusive;
            # svlen = end0 + 1 - pos0) — without it, vartype-filtered FDR
            # would drop every such record
            info["END"] = v.pos + v.svlen
    if not v.precise and v.cipos is not None:
        # write_record_aux_info (calling/variants/mod.rs:162-176): imprecise
        # variants carry IMPRECISE + the candidate's raw CIPOS (and CIEND)
        info["IMPRECISE"] = True
        info["CIPOS"] = f"{v.cipos[0]},{v.cipos[1]}"
        if v.ciend is not None:
            info["CIEND"] = f"{v.ciend[0]},{v.ciend[1]}"
    if v.haplotype:
        # the reference writes the haplotype identifier back as EVENT INFO
        # (calling/variants/mod.rs:411-413,626-628); MATEID-joined groups
        # are Event("id1-id2") too (variants/model/mod.rs:94-105).  FDR
        # breakend-group dedup and keep-decision sharing key on this tag.
        if v.haplotype.startswith("event:"):
            info["EVENT"] = v.haplotype[len("event:"):]
        elif v.haplotype.startswith("mates:"):
            info["EVENT"] = "-".join(v.haplotype[len("mates:"):].split(","))
    if res["hints"]:
        info["HINTS"] = ",".join(res["hints"])
    # --propagate-info-fields passthrough (utils/aux_info.rs:52-135)
    if getattr(v, "aux_info", None):
        for k, val in v.aux_info.items():
            info.setdefault(k, val)

    samples = []
    for si in res["sample_infos"]:
        if missing_data:
            # the reference omits all FORMAT fields on missing data
            # (calling/variants/mod.rs:469); "." is the text-VCF equivalent
            samples.append({k: "." for k in _FORMAT_KEYS})
            continue
        afd = si["afd"]
        afd_str = (
            ",".join(
                f"{np.format_float_positional(np.float32(vaf), unique=True, trim='-')}"
                f"={np_phred_from_log(p):.2f}"
                for vaf, p in sorted(afd.items())
                if np.isfinite(np_phred_from_log(p))
            )
            if afd
            else "."
        )
        art = si.get("artifacts", {})
        samples.append(
            {
                "DP": str(si["dp"]),
                "AF": f"{si['af']:.4f}",
                "OBS": _obs_string(si["pileup"]),
                "SAOBS": _simple_obs_string(si["pileup"], True),
                "SROBS": _simple_obs_string(si["pileup"], False),
                "OOBS": str(si["pileup"].n_filtered_out),
                "SB": art.get("SB", "."),
                "ROB": art.get("ROB", "."),
                "RPB": art.get("RPB", "."),
                "SCB": art.get("SCB", "."),
                "HE": art.get("HE", "."),
                "ALB": art.get("ALB", "."),
                "AFD": afd_str or ".",
            }
        )
    return VcfRecord(
        chrom=v.chrom,
        pos=v.pos,
        id=".",
        ref=v.ref_allele,
        alts=[v.alt_allele],
        info=info,
        format=list(_FORMAT_KEYS),
        samples=samples,
    )
