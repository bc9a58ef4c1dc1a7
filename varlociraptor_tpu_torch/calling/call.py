"""Calling pipeline: N observation files -> posterior calls VCF (torch port).

Counterpart of ``varlociraptor_tpu/calling/call.py`` restricted to the
columnar path: lockstep reading of per-sample observation windows, the
engine per (contig, event set), dispatch-ahead of windows to the device
while a drain thread fetches, formats and writes earlier ones.  The legacy
per-WorkItem path (plug-in hooks that need Pileup objects, reference
observation BCF input) and the device mesh are not ported yet.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..grammar.compiler import compile_scenario_events
from ..grammar.scenario import Scenario
from ..io.vcf import VcfWriter, open_variant_writer
from ..ops.grid import AFGrid
from ..ops.prior import build_prior

from ..device import resolve_device
from ..ops.biases import FULL_COMBOS_DEFAULT as FULL_COMBOS
from ..ops.posterior import PosteriorEngine, SampleConfig
from .ref_obs import open_observations

# loci per window of the columnar path
DEFAULT_COLUMNAR_BATCH = 1024
# windows in flight on the device while the drain thread fetches, formats
# and writes earlier ones (the bounded queue is the backpressure)
DISPATCH_DEPTH = 4


@dataclass
class CallOptions:
    omit_strand_bias: bool = False
    omit_read_orientation_bias: bool = False
    omit_read_position_bias: bool = False
    omit_softclip_bias: bool = False
    omit_homopolymer_artifact_detection: bool = False
    omit_alt_locus_bias: bool = False
    full_prior: bool = False
    batch_size: int | None = None  # None = DEFAULT_COLUMNAR_BATCH
    resolution: float = 0.01

    def effective_batch(self) -> int:
        if self.batch_size is not None:
            return self.batch_size
        return DEFAULT_COLUMNAR_BATCH


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


class GenericCaller:
    def __init__(
        self,
        scenario: Scenario,
        options: CallOptions | None = None,
        device="cuda",
    ):
        self.scenario = scenario
        self.options = options or CallOptions()
        self.device = resolve_device(device)
        self._engines = {}
        self._events_cache = {}
        self._prior_cache = {}

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

    def _full_prior_table(self, contig, variant, prior, value_lists):
        """Joint prior table for --full-prior on the engine's per-sample
        active subgrids (the axes the engine integrates), cached per
        (contig, vartype, per-variant overrides): the table is
        locus-independent unless the candidate carries HETEROZYGOSITY /
        SOMATIC_EFFECTIVE_MUTATION_RATE INFO overrides (prior.rs:251-271)."""
        key = (
            contig,
            variant.kind,
            variant.heterozygosity,
            variant.somatic_effective_mutation_rate,
            len(value_lists),
        )
        cache = getattr(self, "_full_prior_tables", None)
        if cache is None:
            cache = self._full_prior_tables = {}
        hit = cache.get(key)
        if hit is not None:
            return hit
        shapes = tuple(len(v) for v in value_lists)
        size = int(np.prod(shapes))
        if size > 2_000_000:
            from ..errors import InvalidPriorConfigurationError

            raise InvalidPriorConfigurationError(
                f"--full-prior joint grid has {size} cells over "
                f"{len(value_lists)} samples; coarsen per-sample "
                "`resolution:` in the scenario"
            )
        vals = [np.asarray(v, dtype=np.float64) for v in value_lists]
        prior.is_absent_only = False
        try:
            table = np.zeros(shapes, dtype=np.float32)
            for idx in np.ndindex(*shapes):
                table[idx] = prior.compute(
                    [vals[s][idx[s]] for s in range(len(vals))]
                )
        finally:
            prior.is_absent_only = True
        cache[key] = table
        return table


_FORMAT_KEYS = (
    "DP", "AF", "OBS", "SAOBS", "SROBS", "OOBS",
    "SB", "ROB", "RPB", "SCB", "HE", "ALB", "AFD",
)


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
    """Full calling pipeline (cli.rs call_generic equivalent), columnar path.

    observation_paths: {sample_name: path}, must cover scenario samples.
    ``device``: where the posterior engine runs ("cuda" or "cpu").
    Returns number of records called."""
    options = options or CallOptions()
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-device sharding) is not ported yet: ROADMAP A11"
        )
    if call_processor is not None or candidate_filter is not None:
        raise NotImplementedError(
            "call_processor / candidate_filter need the legacy per-WorkItem "
            "path, which is not ported yet: ROADMAP A8b"
        )
    if not any(name in observation_paths for name in scenario.sample_names):
        raise ValueError("no observation files given")
    from .columnar import ColumnarBatch
    from .fastcall import ColumnarCaller

    caller = ColumnarCaller(scenario, options, device=device)

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

    # periodic progress logging, mirroring the reference's 20-second
    # progress_logger in the calling loop (calling.rs:349-352)
    log = logging.getLogger("varlociraptor_tpu_torch.call")
    t0 = time.monotonic()

    readers = [
        open_observations(observation_paths[name], name)
        if name in observation_paths
        else None
        for name in scenario.sample_names
    ]
    if not all(r is None or hasattr(r, "read_window") for r in readers):
        raise NotImplementedError(
            "observation files without columnar windows (reference "
            "observation BCF/VCF) need the legacy per-WorkItem path, which "
            "is not ported yet: ROADMAP A8b"
        )

    window_n = options.effective_batch()

    with open_variant_writer(
        output_path, sample_names=sample_names, header_lines=header
    ) as w:
        text_ok = type(w) is VcfWriter  # vectorized text fast path
        out_q: queue.Queue = queue.Queue(maxsize=DISPATCH_DEPTH)
        state = {"n": 0, "last_log": time.monotonic(), "err": None}

        def drain_loop():
            while True:
                item = out_q.get()
                if item is None:
                    return
                if state["err"] is not None:
                    continue  # drain remaining items after a failure
                cb_p, pw = item
                try:
                    out, meta = pw.finish()
                    if text_ok:
                        w._fh.write(
                            caller.format_window_text(
                                cb_p, out, meta, sample_names
                            )
                        )
                        state["n"] += cb_p.L
                    else:
                        for rec in caller.format_window(
                            cb_p, out, meta, sample_names
                        ):
                            w.write(rec)
                            state["n"] += 1
                    now = time.monotonic()
                    if now - state["last_log"] >= 20.0:
                        log.info(
                            "called %d records (%.0f records/s)",
                            state["n"],
                            state["n"] / max(now - t0, 1e-9),
                        )
                        state["last_log"] = now
                except BaseException as e:  # surfaced on the main thread
                    state["err"] = e

        drainer = threading.Thread(target=drain_loop, name="vlt-drain")
        drainer.start()
        try:
            while True:
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
                pw = caller.call_window_cb(cb, cb.variants[0].chrom, sync=False)
                out_q.put((cb, pw))
                if state["err"] is not None:
                    break
        finally:
            out_q.put(None)
            drainer.join()
        if state["err"] is not None:
            raise state["err"]
        return state["n"]
