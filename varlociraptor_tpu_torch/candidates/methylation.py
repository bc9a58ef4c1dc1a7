"""Methylation candidate discovery: scan FASTA for motifs, emit <METH>
candidates.

Port of ``src/candidates/methylation.rs:15-123``: motifs
CG / CHG / CHH / GATC (H = A|C|T), one candidate per motif hit with the
position of the C (or the GATC A-context for dam methylation).
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import FastaBuffer
from ..io.vcf import VcfRecord, VcfWriter, open_variant_writer

H = {65, 67, 84}  # A, C, T


def _motif_positions(seq: np.ndarray, motif: str):
    s = seq
    n = len(s)
    if motif == "CG":
        idx = np.nonzero((s[:-1] == 67) & (s[1:] == 71))[0]
        return idx
    if motif == "CHG":
        if n < 3:
            return np.array([], dtype=int)
        h = np.isin(s[1:-1], list(H))
        idx = np.nonzero((s[:-2] == 67) & h & (s[2:] == 71))[0]
        return idx
    if motif == "CHH":
        if n < 3:
            return np.array([], dtype=int)
        h1 = np.isin(s[1:-1], list(H))
        h2 = np.isin(s[2:], list(H))
        idx = np.nonzero((s[:-2] == 67) & h1 & h2)[0]
        return idx
    if motif == "GATC":
        if n < 4:
            return np.array([], dtype=int)
        idx = np.nonzero((s[:-3] == 71) & (s[1:-2] == 65) & (s[2:-1] == 84) & (s[3:] == 67))[0]
        return idx + 1  # position of the A (dam methylation)
    raise ValueError(f"unknown motif {motif}")


def find_candidates(reference_path, output_path, motif: str = "CG") -> int:
    """``motif`` may be a comma-separated list (cli.rs:128-132); positions
    are merged and emitted in coordinate order per contig."""
    fasta = FastaBuffer(reference_path)
    motifs = [m.strip() for m in str(motif).split(",") if m.strip()]
    n = 0
    header = [
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type">',
        f"##methylation_motif={','.join(motifs)}",
    ]
    with open_variant_writer(output_path, header_lines=header) as w:
        for contig in fasta.contigs():
            seq = fasta.seq(contig)
            positions = sorted(
                {
                    int(p)
                    for m in motifs
                    for p in _motif_positions(seq, m)
                }
            )
            for pos in positions:
                w.write(
                    VcfRecord(
                        chrom=contig,
                        pos=pos,
                        id=".",
                        ref=chr(seq[pos]),
                        alts=["<METH>"],
                    )
                )
                n += 1
    return n
