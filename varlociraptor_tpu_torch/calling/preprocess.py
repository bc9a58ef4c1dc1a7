"""Preprocess: candidates + BAM + FASTA -> observation file.

Port of ``varlociraptor_tpu/calling/preprocess.py``, which mirrors
``ObservationProcessor``
(``src/calling/variants/preprocessing/mod.rs:190-466``):
streams sorted candidate records, instantiates the typed variant per
candidate, extracts one pileup per locus, and writes the observation
artifact.  Variant types currently routed: SNV, MNV, ref-site (``<*>``),
deletion, insertion (realignment-based types use the batched pair-HMM in
ops.pairhmm via evidence.realignment).

Differences from the JAX package's preprocess:

* the pair-HMM runs on an explicit ``device`` ("cuda" or "cpu"), which
  reaches each realigner's ``BatchedPairHMM`` here (``build_variant``,
  ``_process_breakend_group``), so that ``evidence/realignment.py`` stays a
  verbatim copy;
* ``device_chunk=0`` picks by device: 64 loci per pair-HMM call on the card,
  1 (per locus, the reference's sequential semantics) on the CPU;
* ``pairhmm_mode="homopolymer"`` runs the positional-gap kernel K4 with the
  alignment properties' hop params (K2 / K3 when the estimate found none);
* host worker processes (``n_workers > 1``) are not ported and raise
  (ROADMAP A12).
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace

from ..calling.variants import VariantInfo, collect_variants
from ..estimation.alignment_properties import AlignmentProperties
from ..io.bam import BamReader
from ..io.fasta import FastaBuffer
from ..io.vcf import open_variant_file

from ..device import resolve_device
from ..evidence.extraction import extract_observations
from ..evidence.variants import Mnv, RefSite, Snv
from .observations import ObservationWriter


@dataclass
class PreprocessOptions:
    max_depth: int = 200
    indel_window: int = 64
    realign_indel_reads: bool = True
    adjust_prob_mapping: bool = True
    pairhmm_mode: str = "exact"
    omit_insert_size: bool = False
    propagate_info_fields: tuple = ()
    report_fragment_ids: bool = False
    # debug observability: per-locus TSV dump of raw observations
    # (preprocessing/mod.rs:251-280, --output-raw-observations)
    output_raw_observations: str | None = None
    # region sharding (CHROM or CHROM:START-END, 1-based inclusive): the
    # ecosystem pattern for data parallelism — run one preprocess per
    # region shard, then chain the shards at call time
    region: str | None = None
    # "default": progress every 100 records; "each-record": per-record
    # logging (cli.rs:348-357 --log-mode)
    log_mode: str = "default"
    # host worker processes; only 1 is ported (ROADMAP A12)
    n_workers: int = 1
    # cross-locus device batching: pair-HMM forwards of this many loci are
    # concatenated into ONE device call (per-call launch and copy latency
    # dominates small per-pileup batches). 1 = execute per locus (the
    # reference's sequential semantics — the alignment-property maxima
    # ratchet advances between loci; with chunking it advances per chunk).
    # 0 = auto: 64 on the card, 1 on the CPU.
    device_chunk: int = 0
    # contigs kept in the FASTA LRU buffer (--reference-buffer-size,
    # cli.rs:268-276, reference default 10)
    reference_buffer_size: int = 10


def build_variant(info: VariantInfo, reference: FastaBuffer, options, props,
                  device):
    """Instantiate the typed variant for a candidate (preprocessing/mod.rs
    process_pileup dispatch :468-807); its pair-HMM runs on ``device``."""
    ref_seq = reference.seq(info.chrom)
    from ..evidence.realignment import Realigner

    realigner = Realigner(
        reference=reference,
        props=props,
        indel_window=options.indel_window,
        max_window=options.indel_window,
        mode=options.pairhmm_mode,
    )
    realigner.hmm.device = device
    if info.kind == "snv":
        return Snv(
            info.chrom,
            info.pos,
            int(ref_seq[info.pos]),
            ord(info.alt_allele[0]),
            realigner=realigner if options.realign_indel_reads else None,
        )
    if info.kind == "mnv":
        return Mnv(
            info.chrom,
            info.pos,
            bytes(info.ref_allele, "ascii"),
            bytes(info.alt_allele, "ascii"),
            realigner=realigner if options.realign_indel_reads else None,
        )
    if info.kind == "none":
        return RefSite(info.chrom, info.pos, int(ref_seq[info.pos]))
    if info.kind == "deletion":
        from ..evidence.indels import Deletion

        return Deletion(info.chrom, info.pos, info.svlen, realigner)
    if info.kind == "insertion":
        from ..evidence.indels import Insertion

        return Insertion(info.chrom, info.pos, info.alt_seq.encode(), realigner)
    if info.kind == "inversion":
        from ..evidence.indels import Inversion

        return Inversion(info.chrom, info.pos, info.svlen, realigner)
    if info.kind == "duplication":
        from ..evidence.indels import Duplication

        return Duplication(info.chrom, info.pos, info.svlen, realigner)
    if info.kind == "replacement":
        from ..evidence.indels import Replacement

        return Replacement(
            info.chrom, info.pos, info.ref_allele.encode(), info.alt_seq.encode(), realigner
        )
    if info.kind == "methylation":
        from ..evidence.methylation import Methylation

        return Methylation(info.chrom, info.pos)
    raise NotImplementedError(f"variant type {info.kind} not yet routed")


def preprocess(
    candidates_path,
    bam_path,
    reference_path,
    output_path,
    sample_name: str = "sample",
    alignment_properties: AlignmentProperties | None = None,
    options: PreprocessOptions | None = None,
    reference: FastaBuffer | None = None,
    bam: BamReader | None = None,
    device="cuda",
):
    """Run preprocessing for one sample; returns count of processed records.

    ``device``: where the pair-HMM forwards run ("cuda" or "cpu"); asking
    for the card without one raises."""
    options = options or PreprocessOptions()
    device = resolve_device(device)
    if options.n_workers > 1:
        raise NotImplementedError(
            "preprocess with several host worker processes (--threads > 1) "
            "is not ported yet: ROADMAP A12"
        )
    reference = reference or FastaBuffer(
        reference_path, capacity=options.reference_buffer_size
    )
    # CRAM inputs decode against the same reference buffer
    bam = bam or BamReader(bam_path, reference=reference)
    if alignment_properties is None:
        from ..estimation.alignment_properties import estimate

        alignment_properties = estimate(
            bam, omit_insert_size=options.omit_insert_size, reference=reference
        )

    # haplotype feature index: last record index per haplotype id
    # (preprocessing/haplotype_feature_index.rs:10-50)
    records = list(open_variant_file(candidates_path))
    # reject unsorted candidates like the reference (variant_buffer.rs:58-138
    # state machine assumes coordinate-sorted input)
    last = {}
    order = []
    for r in records:
        if r.chrom not in last:
            last[r.chrom] = r.pos
            order.append(r.chrom)
        elif r.pos < last[r.chrom]:
            from ..errors import UnsortedVariantFileError

            raise UnsortedVariantFileError(
                f"{r.chrom}:{last[r.chrom] + 1}", f"{r.chrom}:{r.pos + 1}"
            )
        elif r.chrom != order[-1]:
            raise ValueError(
                f"candidate records are not grouped by contig: {r.chrom} "
                "reappears after other contigs; sort the candidate file first"
            )
        else:
            last[r.chrom] = r.pos
    if options.region:
        import re as _re

        m = _re.match(r"^([^:]+)(?::(\d+)-(\d+))?$", options.region)
        if not m:
            raise ValueError(f"invalid region {options.region!r}")
        chrom, start, end = m.group(1), m.group(2), m.group(3)
        lo = int(start) - 1 if start else 0
        hi = int(end) if end else float("inf")
        records = [
            r for r in records if r.chrom == chrom and lo <= r.pos < hi
        ]

    last_of_haplotype = {}
    locus_groups: dict[tuple, list] = {}
    _REALIGNABLE = {
        "snv",
        "mnv",
        "deletion",
        "insertion",
        "inversion",
        "duplication",
        "replacement",
    }
    # collect variants exactly once so identity comparisons (self-exclusion
    # from alt-variant groups) work
    record_variants = [collect_variants(rec) for rec in records]
    for i, infos in enumerate(record_variants):
        for info in infos:
            if info.haplotype is not None:
                last_of_haplotype[info.haplotype] = i
            if info.kind in _REALIGNABLE:
                # same-locus candidates act as competing alt alleles during
                # realignment (utils/variant_buffer.rs:14-138)
                locus_groups.setdefault((info.chrom, info.pos), []).append(info)

    if options.device_chunk == 0:
        # auto: chunk on the card (per-call launch and copy latency dominates
        # there), per locus on the CPU (the reference-exact ratchet)
        options = _dc_replace(
            options, device_chunk=64 if device.type == "cuda" else 1
        )

    n = 0
    skipped = {}
    pending_groups: dict[str, list] = {}
    from ..evidence.extraction import (
        FragmentIdFactory,
        extract_observations_begin,
        extract_observations_finish,
    )
    import numpy as _np

    fragment_ids = FragmentIdFactory() if options.report_fragment_ids else None
    current_contig = None
    # .bcf/.vcf output -> the reference's observation format v15 (so the
    # wider varlociraptor ecosystem can consume our preprocess output);
    # anything else -> the native versioned JSON-lines format
    if str(output_path).endswith((".bcf", ".vcf")):
        from .ref_obs import ReferenceObservationWriter as _WriterCls
    else:
        _WriterCls = ObservationWriter
    with _WriterCls(
        output_path,
        sample_name=sample_name,
        options={
            "max_depth": options.max_depth,
            "indel_window": options.indel_window,
            "pairhmm_mode": options.pairhmm_mode,
            "alignment_properties": alignment_properties.to_json(),
            "reference": str(reference_path),
            "bam": str(bam_path),
            "candidates": str(candidates_path),
        },
    ) as writer:
        chunk: list = []  # [(info, pending, aux)] awaiting the device flush

        def _log_progress(info):
            nonlocal n
            n += 1
            if options.log_mode != "silent" and (
                options.log_mode == "each-record" or n % 100 == 0
            ):
                import sys as _sys

                print(
                    f"preprocess: {n} records processed "
                    f"(at {info.chrom}:{info.pos + 1})",
                    file=_sys.stderr,
                )

        def _flush_chunk():
            """Execute the pair-HMM forwards of all chunked loci as ONE
            padded device call, then finish + write them in record order."""
            if not chunk:
                return
            realigners = [
                r for _i, p, _a in chunk for r in p.realigners
            ]
            seqs, reads, quals, dists, counts = [], [], [], [], []
            for r in realigners:
                s, rd, q, d = r.collect_requests()
                counts.append(len(s))
                seqs.extend(s)
                reads.extend(rd)
                quals.extend(q)
                dists.extend(d)
            if seqs:
                results = _np.asarray(
                    realigners[0].hmm.forward(seqs, reads, quals, dists),
                    dtype=_np.float64,
                )
            else:
                results = _np.zeros(0)
            off = 0
            for r, c in zip(realigners, counts):
                r.set_results(results[off : off + c])
                off += c
            for info, pending, aux in chunk:
                pileup = extract_observations_finish(pending)
                writer.write_record(info, pileup, aux=aux)
                if options.output_raw_observations:
                    _dump_raw_observations(
                        options.output_raw_observations, info, pileup
                    )
                _log_progress(info)
            chunk.clear()

        for i, rec in enumerate(records):
            for info in record_variants[i]:
                if info.kind == "breakend" and info.haplotype is not None:
                    _flush_chunk()
                    from ..evidence.breakends import Breakend

                    ci = (0, 0)
                    if not info.precise and info.cipos is not None:
                        ci = info.cipos
                    try:
                        bnd = Breakend.parse(
                            info.chrom,
                            info.pos,
                            info.ref_allele,
                            info.spec,
                            rec.id or ".",
                            str(rec.info_get("MATEID") or "") or None,
                            precise=info.precise,
                            ci=ci,
                        )
                    except ValueError:
                        skipped["breakend"] = skipped.get("breakend", 0) + 1
                        # fall through WITHOUT `continue`: if this was the
                        # haplotype's last member, the group must still
                        # flush below or its valid mates would be orphaned
                        # in pending_groups (no records ever written ->
                        # inconsistent observation files across samples)
                        bnd = None
                    if bnd is not None:
                        pending_groups.setdefault(info.haplotype, []).append(
                            (info, bnd)
                        )
                    if last_of_haplotype.get(info.haplotype) == i:
                        members = pending_groups.pop(info.haplotype, [])
                        n += _process_breakend_group(
                            members,
                            reference,
                            bam,
                            alignment_properties,
                            options,
                            writer,
                            skipped,
                            device,
                        )
                    continue
                if info.haplotype is not None and info.kind in _REALIGNABLE:
                    _flush_chunk()
                    # non-BND haplotype block member (haplotype_block.rs)
                    key = "hb:" + info.haplotype
                    pending_groups.setdefault(key, []).append((info, None))
                    if last_of_haplotype.get(info.haplotype) == i:
                        members = [m for m, _ in pending_groups.pop(key, [])]
                        n += _process_haplotype_block(
                            members,
                            reference,
                            bam,
                            alignment_properties,
                            options,
                            writer,
                            skipped,
                            device,
                        )
                    continue
                try:
                    variant = build_variant(
                        info, reference, options, alignment_properties, device
                    )
                except NotImplementedError:
                    skipped[info.kind] = skipped.get(info.kind, 0) + 1
                    continue
                alt_variants = []
                for other in locus_groups.get((info.chrom, info.pos), []):
                    if other is info:
                        continue
                    try:
                        alt_variants.append(
                            build_variant(
                                other, reference, options, alignment_properties,
                                device,
                            )
                        )
                    except NotImplementedError:
                        pass
                if fragment_ids is not None and info.chrom != current_contig:
                    # pending chunk loci belong to the previous contig and
                    # must take their ids from the map BEFORE it resets
                    _flush_chunk()
                    fragment_ids.reset()
                    current_contig = info.chrom
                aux = {
                    f: rec.info_get(f)
                    for f in options.propagate_info_fields
                    if rec.info_get(f) is not None
                } or None
                if options.device_chunk > 1:
                    pending = extract_observations_begin(
                        variant,
                        bam,
                        alignment_properties,
                        max_depth=options.max_depth,
                        alt_variants=alt_variants,
                        do_adjust_prob_mapping=options.adjust_prob_mapping,
                        fragment_id_factory=fragment_ids,
                    )
                    chunk.append((info, pending, aux))
                    if len(chunk) >= options.device_chunk:
                        _flush_chunk()
                else:
                    pileup = extract_observations(
                        variant,
                        bam,
                        alignment_properties,
                        max_depth=options.max_depth,
                        alt_variants=alt_variants,
                        do_adjust_prob_mapping=options.adjust_prob_mapping,
                        fragment_id_factory=fragment_ids,
                    )
                    writer.write_record(info, pileup, aux=aux)
                    if options.output_raw_observations:
                        _dump_raw_observations(
                            options.output_raw_observations, info, pileup
                        )
                    _log_progress(info)
                # skip-reason counters every 100 skips
                # (variant_buffer.rs:59-60,189-195)
                n_skipped = sum(skipped.values())
                if n_skipped and n_skipped % 100 == 0 and skipped != getattr(
                    preprocess, "_last_reported_skips", None
                ):
                    import sys as _sys

                    print(
                        f"preprocess: skipped so far: {dict(skipped)}",
                        file=_sys.stderr,
                    )
                    preprocess._last_reported_skips = dict(skipped)
        _flush_chunk()
    if skipped:
        import sys

        print(f"preprocess: skipped unsupported variants: {skipped}", file=sys.stderr)
    return n


def _process_haplotype_block(
    members, reference, bam, props, options, writer, skipped, device
) -> int:
    """Joint pileup for non-BND variants sharing an EVENT
    (haplotype_block.rs; preprocessing/mod.rs:398-462)."""
    if not members:
        return 0
    from ..evidence.haplotype_block import HaplotypeBlock

    variants = []
    for info in members:
        try:
            variants.append(build_variant(info, reference, options, props, device))
        except NotImplementedError:
            skipped[info.kind] = skipped.get(info.kind, 0) + 1
    if not variants:
        return 0
    block = HaplotypeBlock(members[0].chrom, variants)
    pileup = extract_observations(
        block,
        bam,
        props,
        max_depth=options.max_depth,
        do_adjust_prob_mapping=options.adjust_prob_mapping,
    )
    for info in members:
        writer.write_record(info, pileup)
    return len(members)


def _process_breakend_group(
    members, reference, bam, props, options, writer, skipped, device
) -> int:
    """Extract one shared pileup for a completed breakend group and write one
    observation record per member (preprocessing/mod.rs:344-396)."""
    if not members:
        return 0
    from ..evidence.breakends import BreakendGroup
    from ..evidence.realignment import Realigner

    realigner = Realigner(
        reference=reference,
        props=props,
        indel_window=options.indel_window,
        max_window=options.indel_window,
    )
    realigner.hmm.device = device
    infos = [info for info, _ in members]
    bnds = [bnd for _, bnd in members]
    group = BreakendGroup.build(infos[0].chrom, bnds, realigner)
    if group is None:
        skipped["breakend"] = skipped.get("breakend", 0) + len(members)
        return 0
    pileup = extract_observations(
        group,
        bam,
        props,
        max_depth=options.max_depth,
        do_adjust_prob_mapping=options.adjust_prob_mapping,
    )
    for info in infos:
        writer.write_record(info, pileup)
    return len(infos)


def _dump_raw_observations(prefix, info, pileup):
    """Per-locus TSV of raw observations (preprocessing/mod.rs:251-280)."""
    import os

    os.makedirs(prefix, exist_ok=True)
    path = os.path.join(
        prefix, f"{info.chrom}_{info.pos}_{info.kind}.tsv"
    )
    cols = [
        "name",
        "prob_mapping",
        "prob_alt",
        "prob_ref",
        "prob_missed_allele",
        "prob_sample_alt",
        "strand",
        "read_orientation",
        "read_position",
        "softclipped",
        "paired",
        "homopolymer_indel_len",
        "is_max_mapq",
        "alt_locus",
        "third_allele_evidence",
    ]
    with open(path, "w") as f:
        print("\t".join(cols), file=f)
        for o in pileup.read_observations:
            print(
                "\t".join(
                    str(
                        getattr(o, "eff_prob_mapping", lambda: None)()
                        if c == "prob_mapping"
                        else getattr(o, c, None)
                    )
                    for c in cols
                ),
                file=f,
            )
