"""Derive diploid GT from MAP allele frequencies.

Port of ``src/conversion/genotype.rs:17-52``: AF exactly
0.5 -> 0/1, exactly 1.0 -> 1/1, exactly 0.0 -> 0/0; any other AF with
DP > 0 is called heterozygous 0/1 (most likely case: a subclone); missing
AF or no observations -> ./.
"""

from __future__ import annotations

import math

from ..io.vcf import VcfReader, open_variant_file, VcfWriter, open_variant_writer


def af_to_gt(af: float | None, dp: int | None = 1) -> str:
    if af is None:
        return "./."
    if math.isclose(af, 0.5, rel_tol=1e-6, abs_tol=1e-9):
        return "0/1"
    if math.isclose(af, 1.0, rel_tol=1e-6):
        return "1/1"
    if math.isclose(af, 0.0, rel_tol=1e-6, abs_tol=1e-9):
        return "0/0"
    if dp is not None and dp > 0:
        # VAF < 1.0 but not exactly 0.5: still the most likely genotype is
        # heterozygous (in a subclone of the cells), genotype.rs:35-38
        return "0/1"
    return "./."


def genotype(in_path, out_path=None):
    reader = open_variant_file(in_path)
    records = reader.records()
    header = reader.header_lines + [
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype from MAP AF">'
    ]
    with open_variant_writer(out_path, sample_names=reader.sample_names, header_lines=header) as w:
        for rec in records:
            if "GT" not in rec.format:
                rec.format = ["GT"] + rec.format
            for s in rec.samples:
                try:
                    af = float(s.get("AF", "nan"))
                    af = None if af != af else af
                except ValueError:
                    af = None
                try:
                    dp = int(s.get("DP", "."))
                except ValueError:
                    dp = None
                s["GT"] = af_to_gt(af, dp)
            w.write(rec)
