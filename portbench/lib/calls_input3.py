"""The three-sample call cell's inputs: a tumor, its relapse and the
matched normal, drawn from the seed.

The draw follows the configuration's ``call_input`` block: candidates one
per ``spacing`` bases of ``genome_len``, each of a class of ``mix``.  A
germline heterozygous candidate has allele frequency 0.5 in all three
samples; a somatic one has, in the tumor and the relapse, the sample's
``purity`` x the class's ``cancer_cell_fraction`` there x 0.5 (a
heterozygous mutation in that share of the cancer cells), and 0 in the
normal; a decoy is 0 everywhere.  Each sample's reads are drawn as the
two-sample cell draws them (``calls_input._sample_reads``): depth
Poisson(``coverage``), the library's base qualities and errors.

:func:`draw` returns what ``calls_input.draw`` returns, with three samples;
``calls_input.select`` and ``calls_input.write_files`` take it as it is.
"""

from __future__ import annotations

import numpy as np

from .calls_input import BASES, _sample_reads

HET = 0.5


def allele_frequencies(config, kind, names):
    """{sample: allele frequency at each locus} of the class indices
    ``kind`` into ``names`` (the mix's classes in order)."""
    lib = config["call_input"]
    ccf = lib["cancer_cell_fraction"]
    germline = kind == names.index("germline_het")
    vaf = {"normal": np.where(germline, HET, 0.0)}
    for i, sample in enumerate(("tumor", "relapse")):
        somatic = np.zeros(len(kind))
        for cls, fractions in ccf.items():
            somatic[kind == names.index(cls)] = fractions[i]
        vaf[sample] = np.where(germline, HET,
                               config["purity"][sample] * somatic * HET)
    return vaf


def draw(config, seed, chrom="chr1"):
    """{"chrom", "pos" (0-based), "ref", "alt", "truth", "samples": {name:
    (counts, columns)}} of the candidates of the configuration's
    ``genome_len`` bases, from the seed; samples in the configuration's
    order."""
    lib = config["call_input"]
    n_loci = int(config["genome_len"] // lib["spacing"])
    rng = np.random.default_rng(seed)
    mix = lib["mix"]
    names = list(mix)
    kind = rng.choice(len(mix), n_loci, p=[mix[k] for k in mix])
    vaf = allele_frequencies(config, kind, names)
    ref_i = rng.integers(0, 4, n_loci)
    alt_i = (ref_i + rng.integers(1, 4, n_loci)) % 4
    pos = lib["spacing"] * (1 + np.arange(n_loci, dtype=np.int64))
    samples = {name: _sample_reads(rng, vaf[name], lib) for name in config["samples"]}
    return {"chrom": chrom, "pos": pos, "ref": BASES[ref_i], "alt": BASES[alt_i],
            "truth": np.asarray(names)[kind], "samples": samples}
