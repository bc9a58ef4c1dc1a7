"""PHRED -> linear probability conversion of PROB_* INFO fields.

Port of ``src/conversion/decode_phred.rs``.
"""

from __future__ import annotations

import math
import sys

from ..io.vcf import VcfReader, open_variant_file, VcfWriter, open_variant_writer
from ..utils.logprob import np_log_from_phred


def decode_phred(in_path, out_path=None):
    reader = open_variant_file(in_path)
    records = reader.records()
    header = [
        l.replace("PHRED", "linear") if "PROB_" in l else l
        for l in reader.header_lines
    ]
    with open_variant_writer(out_path, sample_names=reader.sample_names, header_lines=header) as w:
        for rec in records:
            for key, val in list(rec.info.items()):
                if key.startswith("PROB_") and val is not True:
                    # Number=A: convert every allele's value; keep missing
                    # ('.') entries as-is (decode_phred.rs:39-50)
                    out = []
                    for part in str(val).split(","):
                        try:
                            phred = float(part)
                        except ValueError:
                            out.append(part)
                            continue
                        out.append(f"{math.exp(np_log_from_phred(phred)):.6g}")
                    rec.info[key] = ",".join(out)
            w.write(rec)
