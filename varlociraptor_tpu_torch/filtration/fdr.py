"""Bayesian FDR control (Mueller, Parmigiani & Rice 2006).

Port of ``src/filtration/fdr.rs`` +
``src/utils/mod.rs:160-420`` (tags_prob_sum,
collect_prob_dist, filter_by_threshold, filter_calls): expected FDR over the
sorted posterior-error-probability distribution, threshold search, local /
global x strict / smart modes, variant-type + length-range filters, and
breakend-group-consistent decisions.

At pod scale the global mode is the one cross-shard reduction in the
pipeline: per-record event-probability sums are all-gathered (a few MB
genome-wide) and the sort/threshold is replicated (SURVEY.md §3.3).
"""

from __future__ import annotations

import math

import numpy as np

from .. import tracing
from ..calling.variants import collect_variants
from ..io.vcf import VcfReader, open_variant_file, VcfWriter, open_variant_writer
from ..utils.logprob import (
    LOG_ZERO,
    NUMERICAL_EPSILON,
    PROB_05,
    np_ln_one_minus_exp,
    np_ln_sum_exp,
    np_log_from_phred,
)

_LN10_NEG10 = -math.log(10.0) / 10.0  # PHRED -> natural log

VARTYPE_KINDS = {
    "SNV": {"snv"},
    "MNV": {"mnv"},
    "INS": {"insertion"},
    "INSERTION": {"insertion"},
    "DEL": {"deletion"},
    "DELETION": {"deletion"},
    "INV": {"inversion"},
    "INVERSION": {"inversion"},
    "DUP": {"duplication"},
    "DUPLICATION": {"duplication"},
    "REP": {"replacement"},
    "REPLACEMENT": {"replacement"},
    "BND": {"breakend"},
    "BREAKEND": {"breakend"},
    "REF": {"none"},
    "NONE": {"none"},
    "METH": {"methylation"},
    "METHYLATION": {"methylation"},
}


def _record_vartype_match(rec, vartype: str | None, min_len=None, max_len=None):
    if vartype is None:
        return True
    kinds = VARTYPE_KINDS.get(vartype.upper())
    if kinds is None:
        raise ValueError(f"unknown variant type filter {vartype!r}")
    variants = collect_variants(rec, skip_imprecise=False)
    if not variants:
        return False
    v = variants[0]
    if kinds and v.kind not in kinds:
        return False
    if min_len is not None or max_len is not None:
        svlen = abs(v.svlen) if v.svlen else abs(
            len(v.alt_allele) - len(v.ref_allele)
        )
        if min_len is not None and svlen < min_len:
            return False
        if max_len is not None and svlen >= max_len:
            return False
    return True


def tags_prob_sum(rec, tags) -> float | None:
    """Sum of linear probs of PROB_* tags in log space, overshoot-capped
    (utils/mod.rs:177-212)."""
    probs = []
    for tag in tags:
        raw = rec.info_get(tag)
        if raw is None or raw is True:
            continue
        try:
            phred = float(str(raw).split(",")[0])
        except ValueError:
            continue
        if math.isnan(phred):
            continue
        probs.append(phred * _LN10_NEG10)
    if not probs:
        return None
    # scalar ln_sum_exp for the 1-2 tag common case (called per record in
    # FDR passes; numpy scalar dispatch dominated the 100K-record profile)
    if len(probs) == 1:
        p = probs[0]
    elif len(probs) == 2:
        a, b = probs
        m = a if a >= b else b
        p = m if m == LOG_ZERO else m + math.log1p(math.exp(min(a, b) - m))
    else:
        p = float(np_ln_sum_exp(np.array(probs)))
    if 0.0 < p <= NUMERICAL_EPSILON:
        p = 0.0
    return min(p, 0.0)


def expected_fdr(sorted_peps):
    """bio::stats::bayesian::expected_fdr: cumulative mean of sorted PEPs."""
    peps = np.asarray(sorted_peps, dtype=np.float64)
    if len(peps) == 0:
        return np.array([])
    lin = np.exp(peps)
    cum = np.cumsum(lin)
    return np.log(np.maximum(cum / np.arange(1, len(peps) + 1), 1e-300))


def _dist_tags(tags, smart, smart_retain_artifacts):
    if smart:
        dist_tags = ["PROB_ABSENT"]
        if not smart_retain_artifacts:
            dist_tags.append("PROB_ARTIFACT")
        return dist_tags
    return tags


def _collect_dist_rows(records, dist_tags, vartype, min_len, max_len):
    """Pass-1 rows: [n, 2] (event-prob sum, breakend EVENT hash or 0).

    The hash column lets the cross-shard path dedupe breakend-group events
    after the collective gather (one group's mates can land on different
    shards); 0 marks records without an EVENT tag."""
    rows = []
    for rec in records:
        if not _record_vartype_match(rec, vartype, min_len, max_len):
            continue
        ev = rec.info_get("EVENT")
        h = 0.0
        if ev and ev is not True:
            import zlib

            h = float(zlib.crc32(str(ev).encode()) or 1)
        p = tags_prob_sum(rec, dist_tags)
        if p is not None:
            rows.append((p, h))
    return np.array(rows, dtype=np.float64).reshape(-1, 2)


def _threshold_from_rows(rows, smart, ln_alpha):
    """Replicated threshold search over the (gathered) prob rows
    (fdr.rs:116-144)."""
    seen = set()
    prob_dist = []
    for p, h in rows:
        if h != 0.0:
            if h in seen:
                continue
            seen.add(h)
        prob_dist.append(p)
    prob_dist.sort()
    prob_dist = prob_dist[::-1]  # descending
    if smart:
        prob_dist = [np_ln_one_minus_exp(p) for p in prob_dist]
    pep_dist = [np_ln_one_minus_exp(p) for p in prob_dist]
    fdrs = expected_fdr(pep_dist)
    if len(fdrs) == 0:
        return None
    if fdrs[0] > ln_alpha:
        return 0.0  # ln_one: nothing passes
    for i in range(len(fdrs) - 1, -1, -1):
        if fdrs[i] <= ln_alpha and (i == 0 or pep_dist[i] != pep_dist[i - 1]):
            return prob_dist[i]
    return None


@tracing.traced("fdr.control")
def control_fdr(
    in_vcf,
    out_vcf,
    events: list[str],
    alpha: float,
    vartype: str | None = None,
    min_len=None,
    max_len=None,
    local: bool = False,
    smart: bool = False,
    smart_retain_artifacts: bool = False,
    reader=None,
) -> int:
    """Filter calls at FDR alpha; returns number of records kept.
    ``reader``: optional pre-opened variant reader for ``in_vcf`` — callers
    filtering the same calls for several event sets skip re-parsing."""
    reader = reader or open_variant_file(in_vcf)
    records = reader.records()
    tags = [f"PROB_{e.upper()}" for e in events]
    # skip events absent from the header; error if none remain
    # (fdr.rs:66-91 InvalidFDRControlEvents)
    header_text = "\n".join(reader.header_lines)
    present = [t for t in tags if f"ID={t}" in header_text]
    if header_text and not present:
        raise ValueError(
            f"none of the events {events} are present in {in_vcf} "
            "(no matching PROB_* INFO definitions)"
        )
    if present and len(present) < len(tags):
        import sys as _sys

        missing = [t for t in tags if t not in present]
        print(f"skipping events not in header: {missing}", file=_sys.stderr)
        tags = present
    ln_alpha = math.log(alpha) if alpha > 0 else LOG_ZERO

    threshold = None
    if local:
        threshold = np_ln_one_minus_exp(ln_alpha)
    elif alpha < 1.0:
        rows = _collect_dist_rows(
            records, _dist_tags(tags, smart, smart_retain_artifacts),
            vartype, min_len, max_len,
        )
        threshold = _threshold_from_rows(rows, smart, ln_alpha)

    # second pass: filter
    n = 0
    bnd_decisions = {}
    tags_q = list(tags)
    absent_tags = ["PROB_ABSENT"]
    if smart and smart_retain_artifacts:
        tags_q.append("PROB_ARTIFACT")
    else:
        absent_tags.append("PROB_ARTIFACT")

    with open_variant_writer(
        out_vcf, sample_names=reader.sample_names, header_lines=reader.header_lines
    ) as w:
        for rec in records:
            if not _record_vartype_match(rec, vartype, min_len, max_len):
                continue
            ev = rec.info_get("EVENT")
            keep = bnd_decisions.get(ev) if ev and ev is not True else None
            if keep is None:
                prob_events = tags_prob_sum(rec, tags_q)
                if smart:
                    pa = tags_prob_sum(rec, absent_tags)
                    p = np_ln_one_minus_exp(pa) if pa is not None else None
                else:
                    p = prob_events
                if p is not None and threshold is not None:
                    keep = p > threshold or math.isclose(
                        p, threshold, rel_tol=1e-9, abs_tol=1e-12
                    )
                elif p is not None and threshold is None:
                    keep = True
                else:
                    keep = False
                if smart:
                    keep = keep and (
                        prob_events is not None and prob_events > PROB_05
                    )
                if ev and ev is not True:
                    bnd_decisions[ev] = keep
            if keep:
                w.write(rec)
                n += 1
    return n


def control_fdr_sharded(
    in_vcfs: list,
    out_vcf,
    events: list[str],
    alpha: float,
    mesh=None,
    vartype: str | None = None,
    min_len=None,
    max_len=None,
    smart: bool = False,
    smart_retain_artifacts: bool = False,
) -> int:
    """Global FDR over region-sharded call files with a collective merge.

    The genome-wide probability distribution (fdr.rs:116-144) is the one
    statistic global FDR needs across shards: each shard contributes its
    pass-1 (prob, event-hash) rows, the mesh ``all_gather`` replicates the
    full distribution (parallel.sharding.all_gather_rows), and the
    threshold search runs identically everywhere.  Shards are then filtered
    independently with the shared threshold — output equals single-file
    ``control_fdr`` on the concatenation.
    """
    from ..parallel.sharding import all_gather_rows, locus_mesh

    readers = [open_variant_file(p) for p in in_vcfs]
    tags = [f"PROB_{e.upper()}" for e in events]
    header_text = "\n".join(readers[0].header_lines)
    present = [t for t in tags if f"ID={t}" in header_text]
    if header_text and not present:
        raise ValueError(
            f"none of the events {events} are present in {in_vcfs[0]}"
        )
    tags = present or tags
    ln_alpha = math.log(alpha) if alpha > 0 else LOG_ZERO

    threshold = None
    if alpha < 1.0:
        dist_tags = _dist_tags(tags, smart, smart_retain_artifacts)
        local_rows = np.concatenate(
            [
                _collect_dist_rows(
                    r.records(), dist_tags, vartype, min_len, max_len
                )
                for r in readers
            ],
            axis=0,
        )
        if mesh is None:
            mesh = locus_mesh()
        rows = all_gather_rows(local_rows, mesh)
        threshold = _threshold_from_rows(rows, smart, ln_alpha)

    n = 0
    bnd_decisions = {}
    tags_q = list(tags)
    absent_tags = ["PROB_ABSENT"]
    if smart and smart_retain_artifacts:
        tags_q.append("PROB_ARTIFACT")
    else:
        absent_tags.append("PROB_ARTIFACT")

    with open_variant_writer(
        out_vcf,
        sample_names=readers[0].sample_names,
        header_lines=readers[0].header_lines,
    ) as w:
        for reader in readers:
            for rec in reader.records():
                if not _record_vartype_match(rec, vartype, min_len, max_len):
                    continue
                ev = rec.info_get("EVENT")
                keep = bnd_decisions.get(ev) if ev and ev is not True else None
                if keep is None:
                    prob_events = tags_prob_sum(rec, tags_q)
                    if smart:
                        pa = tags_prob_sum(rec, absent_tags)
                        p = np_ln_one_minus_exp(pa) if pa is not None else None
                    else:
                        p = prob_events
                    if p is not None and threshold is not None:
                        keep = p > threshold or math.isclose(
                            p, threshold, rel_tol=1e-9, abs_tol=1e-12
                        )
                    elif p is not None and threshold is None:
                        keep = True
                    else:
                        keep = False
                    if smart:
                        keep = keep and (
                            prob_events is not None and prob_events > PROB_05
                        )
                    if ev and ev is not True:
                        bnd_decisions[ev] = keep
                if keep:
                    w.write(rec)
                    n += 1
    return n
