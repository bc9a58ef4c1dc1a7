"""Testcase capture: slice a locus into a self-contained testcase directory.

Mirrors ``TestcaseBuilder`` (``src/testcase/builder.rs:105-505``)
and the anonymizer (``src/utils/anonymize.rs:13-87``):

- select the candidate record(s) at ``--testcase-locus`` (or ``all``)
- pad per variant type (±100 bp point variants, ±1000 bp SVs), extend by
  overlapping read spans, excise the reference window
- slice each sample BAM, shifting coordinates into the excised window
- rewrite candidates.vcf with shifted POS/END (and breakend ALT positions)
- write testcase.yaml in the version-4 format our runner consumes
- optional anonymization: random ACGT permutation of all sequences plus
  uuid4 read names (pair-consistent)

The produced directory replays through ``varlociraptor_tpu_torch.testcase.Testcase``.
"""

from __future__ import annotations

import json
import random
import re
import uuid
from pathlib import Path

import numpy as np

from .calling.variants import collect_variants
from .estimation.alignment_properties import estimate
from .io.bam import BamReader, BamWriter
from .io.fasta import FastaBuffer
from .io.vcf import open_variant_file

_PAD_SMALL = 100
_PAD_SV = 1000

_BND_RE = re.compile(r"([\[\]])([^:\[\]]+):(\d+)([\[\]])")


class Anonymizer:
    """utils/anonymize.rs:13-87: base-permutation chiffre + uuid qnames."""

    def __init__(self, seed=None):
        rng = random.Random(seed)
        perm = list(b"ACGT")
        rng.shuffle(perm)
        self.table = np.arange(256, dtype=np.uint8)
        for src, dst in zip(b"ACGT", perm):
            self.table[src] = dst
            self.table[src | 0x20] = dst
        self.qnames: dict[str, str] = {}

    def seq(self, arr):
        return self.table[np.asarray(arr, dtype=np.uint8)]

    def seq_str(self, s: str) -> str:
        return bytes(self.table[np.frombuffer(s.encode(), dtype=np.uint8)]).decode()

    def qname(self, name: str) -> str:
        if name not in self.qnames:
            self.qnames[name] = str(uuid.uuid4())
        return self.qnames[name]


def _variant_pad(info) -> tuple[int, int]:
    """builder.rs:257-282: region around one candidate."""
    pos = info.pos
    k = info.kind
    if k in ("snv", "none", "methylation"):
        return pos - _PAD_SMALL, pos + 1 + _PAD_SMALL
    if k == "mnv":
        return pos - _PAD_SMALL, pos + len(info.alt_allele) + _PAD_SMALL
    if k == "insertion":
        return pos - _PAD_SV, pos + len(info.alt_allele) + _PAD_SV
    if k in ("deletion", "inversion", "duplication"):
        return pos - _PAD_SV, pos + max(info.svlen, 1) + _PAD_SV
    if k == "replacement":
        return pos - _PAD_SV, pos + len(info.ref_allele) + _PAD_SV
    return pos - _PAD_SV, pos + 1 + _PAD_SV


def build_testcase(
    prefix,
    locus: str,
    candidates_path,
    reference_path,
    sample_bams: dict,
    scenario_path=None,
    sample_options: dict | None = None,
    mode: str = "Generic",
    purity: float | None = None,
    anonymize: bool = False,
) -> Path:
    prefix = Path(prefix)
    prefix.mkdir(parents=True, exist_ok=True)
    anonymizer = Anonymizer() if anonymize else None
    reference = FastaBuffer(reference_path)

    # -- pick candidate records ----------------------------------------
    chrom = pos = None
    if locus != "all":
        m = re.match(r"^(?P<chrom>[^:]+):(?P<pos>\d+)$", locus)
        if not m:
            raise ValueError(f"invalid testcase locus {locus!r} (CHROM:POS or 'all')")
        chrom, pos = m.group("chrom"), int(m.group("pos")) - 1

    records = []
    for rec in open_variant_file(candidates_path):
        if chrom is None or (rec.chrom == chrom and rec.pos == pos):
            records.append(rec)
    if not records:
        raise ValueError(f"no candidate found at {locus}")

    # -- regions per chromosome ----------------------------------------
    regions: dict[str, list] = {}
    for rec in records:
        for info in collect_variants(rec):
            s, e = _variant_pad(info)
            cur = regions.get(info.chrom)
            if cur is None:
                regions[info.chrom] = [max(0, s), e]
            else:
                cur[0] = min(cur[0], max(0, s))
                cur[1] = max(cur[1], e)

    # extend by overlapping read spans (builder.rs:284-308)
    readers = {name: BamReader(path) for name, path in sample_bams.items()}
    extended = {c: [s, e] for c, (s, e) in regions.items()}
    for bam in readers.values():
        for c, (s, e) in regions.items():
            for rec in bam.fetch(c, s, e):
                span = rec.read_len
                extended[c][0] = min(extended[c][0], max(0, rec.pos - span))
                extended[c][1] = max(extended[c][1], rec.end_pos + span)
    for c in extended:
        extended[c][1] = min(extended[c][1], reference.contig_length(c))

    # -- reference excerpt ---------------------------------------------
    with open(prefix / "ref.fa", "w") as f:
        for c, (s, e) in extended.items():
            seq = reference.seq(c)[s:e]
            if anonymizer is not None:
                seq = anonymizer.seq(seq)
            print(f">{c}", file=f)
            print(bytes(seq).decode("latin1"), file=f)

    # -- per-sample BAM slices -----------------------------------------
    samples_yaml = {}
    for name, bam in readers.items():
        props = estimate(BamReader(sample_bams[name]), reference=reference)
        out_bam = f"{name}.bam"
        ref_names = list(extended.keys())
        ref_lengths = [e - s for (s, e) in extended.values()]
        with BamWriter(prefix / out_bam, ref_names, ref_lengths) as w:
            for c, (s, e) in regions.items():
                shift = extended[c][0]
                for rec in sorted(bam.fetch(c, s, e), key=lambda r: r.pos):
                    rec.pos = rec.pos - shift
                    if rec.mtid == rec.tid:
                        rec.mpos = rec.mpos - shift
                    rec.tags.pop("RG", None)
                    if anonymizer is not None:
                        rec.seq = anonymizer.seq(rec.seq)
                        rec.qname = anonymizer.qname(rec.qname)
                        for t in ("MD", "SA", "XA"):
                            rec.tags.pop(t, None)
                    w.write_record(
                        rec,
                        tid=w.tid(c),
                        mtid=w.tid(c) if rec.mtid == rec.tid else -1,
                    )
        opts = (sample_options or {}).get(name) or json.dumps(
            {
                "Preprocess": {
                    "kind": {
                        "Variants": {
                            "reference": "?",
                            "candidates": "?",
                            "bam": "?",
                            "output": "?",
                            "realignment_window": 64,
                            "max_depth": 200,
                            "pairhmm_mode": "exact",
                        }
                    }
                }
            }
        )
        samples_yaml[name] = {
            "path": out_bam,
            "properties": props.to_json(),
            "options": opts,
        }

    # -- candidates.vcf -------------------------------------------------
    with open(prefix / "candidates.vcf", "w") as f:
        print("##fileformat=VCFv4.2", file=f)
        for c, (s, e) in extended.items():
            print(f"##contig=<ID={c},length={e - s}>", file=f)
        print(
            "##INFO=<ID=SVTYPE,Number=1,Type=String,Description=\"SV type\">",
            file=f,
        )
        print(
            "##INFO=<ID=SVLEN,Number=.,Type=Integer,Description=\"SV length\">",
            file=f,
        )
        print(
            "##INFO=<ID=END,Number=1,Type=Integer,Description=\"SV end\">",
            file=f,
        )
        print(
            "##INFO=<ID=MATEID,Number=.,Type=String,Description=\"mate id\">",
            file=f,
        )
        print("##INFO=<ID=EVENT,Number=1,Type=String,Description=\"event\">", file=f)
        print("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO", file=f)
        for rec in records:
            shift = extended[rec.chrom][0]
            ref_allele = rec.ref
            alts = list(rec.alts)
            if anonymizer is not None:
                if all(ch in "ACGTNacgtn" for ch in ref_allele):
                    ref_allele = anonymizer.seq_str(ref_allele)
                alts = [
                    anonymizer.seq_str(a)
                    if all(ch in "ACGTNacgtn" for ch in a)
                    else a
                    for a in alts
                ]

            def _shift_bnd(m):
                c2 = m.group(2)
                p2 = int(m.group(3))
                sh = extended.get(c2, [0])[0]
                return f"{m.group(1)}{c2}:{p2 - sh}{m.group(4)}"

            alts = [_BND_RE.sub(_shift_bnd, a) for a in alts]
            info_items = []
            for k, v in (rec.info or {}).items():
                if k == "END" and v not in (None, True):
                    v = int(v) - shift
                if v is True:
                    info_items.append(k)
                else:
                    info_items.append(f"{k}={v}")
            print(
                "\t".join(
                    [
                        rec.chrom,
                        str(rec.pos - shift + 1),
                        rec.id or ".",
                        ref_allele,
                        ",".join(alts),
                        ".",
                        ".",
                        ";".join(info_items) or ".",
                    ]
                ),
                file=f,
            )

    # -- scenario + yaml ------------------------------------------------
    scenario_name = None
    if scenario_path is not None:
        scenario_name = "scenario.yaml"
        (prefix / scenario_name).write_text(Path(scenario_path).read_text())

    yaml_lines = ["samples:"]
    for name, s in samples_yaml.items():
        yaml_lines.append(f"  {name}:")
        yaml_lines.append(f"    path: '{s['path']}'")
        yaml_lines.append(f"    properties: '{s['properties']}'")
        yaml_lines.append(f"    options: '{s['options']}'")
    yaml_lines.append("")
    yaml_lines.append("candidate: 'candidates.vcf'")
    if scenario_name:
        yaml_lines.append(f"scenario: '{scenario_name}'")
    if purity is not None:
        yaml_lines.append(f"purity: {purity}")
    yaml_lines.append("reference:")
    yaml_lines.append("  path: 'ref.fa'")
    yaml_lines.append(f"mode: {mode}")
    yaml_lines.append("version: '4'")
    (prefix / "testcase.yaml").write_text("\n".join(yaml_lines) + "\n")
    return prefix
