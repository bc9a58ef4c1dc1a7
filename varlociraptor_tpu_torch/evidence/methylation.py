"""5mC methylation evidence.

Port of ``src/variants/types/methylation.rs:25-495``:
ALT allele = "methylated".  Evidence either from MM/ML aux tags
(``extract_mm_ml_5mc``, :130-223) or bisulfite/EMSEQ-converted read logic
(``compute_probs_converted_read``, :306-327). Reads with unexpected bases at
the CpG site (mutations) or non-standard flags are skipped.
"""

from __future__ import annotations

import math

from .extraction import Evidence, OVERLAP_ENCLOSING, locus_overlap
from .observation import STRAND_NONE
from .variants import (
    AlleleSupport,
    VariantType,
    prob_read_base,
    strand_from_record,
)

_VALID_FLAGS = {0, 16, 83, 99, 147, 163}  # methylation.rs read_invalid


def _read_reverse_orientation(record) -> bool:
    """Original-molecule orientation (methylation.rs:486-495): for paired
    reads, mate1-reverse or mate2-forward means the molecule is reverse."""
    if record.is_paired:
        return (record.is_reverse and record.is_first_in_pair) or (
            not record.is_reverse and not record.is_first_in_pair
        )
    return record.is_reverse


def extract_mm_ml_5mc(record) -> dict | None:
    """Parse MM/ML tags into {stored-seq position: log prob methylated}."""
    mm = record.tags.get("MM", record.tags.get("Mm"))
    ml = record.tags.get("ML", record.tags.get("Ml"))
    if not isinstance(mm, str) or ml is None:
        return None
    try:
        ml = [int(x) for x in ml]
    except TypeError:
        return None

    seq = record.seq
    reverse = _read_reverse_orientation(record)
    out = {}
    ml_index = 0
    for block in mm.split(";"):
        if not block:
            continue
        if "," not in block:
            continue
        header, positions_str = block.split(",", 1)
        deltas = [int(x) for x in positions_str.split(",") if x.strip().isdigit()]
        if header.startswith("C+m") or header.startswith("C-m"):
            base = ord("C") if not reverse else ord("G")
            pos_read_base = [
                i for i, c in enumerate(seq) if (int(c) & ~0x20) == base
            ]
            if reverse:
                pos_read_base.reverse()
            meth_pos = 0
            for delta in deltas:
                meth_pos += delta
                if meth_pos < len(pos_read_base):
                    abs_pos = pos_read_base[meth_pos]
                    v = ml[ml_index] if ml_index < len(ml) else 0
                    out[abs_pos] = math.log((float(v) + 0.5) / 256.0)
                else:
                    return None
                ml_index += 1
                meth_pos += 1
        else:
            ml_index += len(deltas)
    return out


def _mutation_occurred(reverse, record, qpos, annotated) -> bool:
    read_base = int(record.seq[qpos]) & ~0x20
    if reverse:
        bad = {ord("C"), ord("A"), ord("T")} if annotated else {ord("C"), ord("T")}
    else:
        bad = {ord("G"), ord("A"), ord("T")} if annotated else {ord("A"), ord("G")}
    return read_base in bad


class Methylation(VariantType):
    def __init__(self, contig: str, pos: int, readtype: str = "auto"):
        self.contig = contig
        self.pos = pos
        self.first_pos = pos
        self.readtype = readtype  # "annotated" | "converted" | "auto"

    def fetch_intervals(self):
        return [(self.pos, self.pos + 1)]

    def is_valid_evidence(self, ev: Evidence, props):
        for rec in ev.records():
            if locus_overlap(rec, self.pos, self.pos + 1) == OVERLAP_ENCLOSING:
                return [0]
        return None

    def _annotated(self, record) -> bool:
        if self.readtype == "annotated":
            return True
        if self.readtype == "converted":
            return False
        return "MM" in record.tags or "Mm" in record.tags

    def _support_per_read(self, record):
        if record.flag not in _VALID_FLAGS:
            return None
        reverse = _read_reverse_orientation(record)
        position = self.pos + (1 if reverse else 0)
        qpos = record.read_pos(position)
        if qpos is None:
            return None
        annotated = self._annotated(record)
        if _mutation_occurred(reverse, record, qpos, annotated):
            return None
        if annotated:
            info = extract_mm_ml_5mc(record)
            if info is None:
                return None
            if qpos in info:
                prob_alt = info[qpos]
                p = 1.0 - math.exp(prob_alt)
                prob_ref = math.log(p) if p > 0 else -math.inf
            else:
                prob_alt = -math.inf
                prob_ref = 0.0
        else:
            ref_base, bis_base = (
                (ord("C"), ord("T")) if not reverse else (ord("G"), ord("A"))
            )
            read_base = int(record.seq[qpos])
            qual = int(record.qual[qpos])
            prob_alt = prob_read_base(read_base, ref_base, qual)
            prob_ref = prob_read_base(read_base, bis_base, qual)
        strand = (
            strand_from_record(record, qpos) if prob_ref != prob_alt else STRAND_NONE
        )
        return AlleleSupport(
            prob_ref=prob_ref, prob_alt=prob_alt, strand=strand, read_position=qpos
        )

    def allele_support(self, ev: Evidence, props, alt_variants=()):
        supports = [
            s
            for s in (self._support_per_read(r) for r in ev.records())
            if s is not None
        ]
        if not supports:
            return None
        out = supports[0]
        for s in supports[1:]:
            out.merge(s)
        return out
