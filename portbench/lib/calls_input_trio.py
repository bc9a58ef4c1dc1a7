"""The trio call cell's inputs: a child and both parents, drawn from the
seed.

The draw follows the configuration's ``call_input`` block: candidates one
per ``spacing`` bases of ``genome_len``, each of a class of ``mix``.  An
``inherited`` candidate takes each parent's genotype (0, 1 or 2
alternative alleles of 2) from Hardy-Weinberg proportions at
``population_af``, drawn again where both parents would be homozygous
reference (a candidate carries its allele somewhere in the family), and the
child's by Mendel: one allele of each parent, each chosen at random.  A
``denovo`` candidate is 0 in both parents and 0.5 in the child; a
``denovo_mosaic`` one 0 in both parents and U(``mosaic_vaf``) in the child;
a decoy is 0 everywhere.  A genotype of k alleles has allele frequency
k / 2.  Each sample's reads are drawn as the two-sample cell draws them
(``calls_input._sample_reads``): depth Poisson(``coverage``), the library's
base qualities and errors.

:func:`draw` returns what ``calls_input.draw`` returns, with three samples;
``calls_input.select`` and ``calls_input.write_files`` take it as it is.
"""

from __future__ import annotations

import numpy as np

from .calls_input import BASES, _sample_reads


def genotypes(rng, n, p):
    """(mother, father, child) alternative allele counts of ``n`` inherited
    candidates: parents from Hardy-Weinberg at ``p``, not both 0; the child
    by Mendel."""
    mother, father = rng.binomial(2, p, n), rng.binomial(2, p, n)
    redraw = (mother == 0) & (father == 0)
    while redraw.any():
        k = int(redraw.sum())
        mother[redraw], father[redraw] = rng.binomial(2, p, k), rng.binomial(2, p, k)
        redraw = (mother == 0) & (father == 0)
    # each parent passes one of its two alleles, chosen at random
    child = (rng.random(n) < mother / 2.0).astype(int) + (rng.random(n) < father / 2.0)
    return mother, father, child


def allele_frequencies(config, kind, names, rng):
    """{sample: allele frequency at each locus} of the class indices
    ``kind`` into ``names`` (the mix's classes in order)."""
    lib = config["call_input"]
    n = len(kind)
    vaf = {s: np.zeros(n) for s in ("mother", "father", "child")}
    inherited = kind == names.index("inherited")
    m, f, c = genotypes(rng, int(inherited.sum()), lib["population_af"])
    vaf["mother"][inherited], vaf["father"][inherited] = m / 2.0, f / 2.0
    vaf["child"][inherited] = c / 2.0
    vaf["child"][kind == names.index("denovo")] = 0.5
    mosaic = kind == names.index("denovo_mosaic")
    lo, hi = lib["mosaic_vaf"]
    vaf["child"][mosaic] = rng.uniform(lo, hi, int(mosaic.sum()))
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
    vaf = allele_frequencies(config, kind, names, rng)
    ref_i = rng.integers(0, 4, n_loci)
    alt_i = (ref_i + rng.integers(1, 4, n_loci)) % 4
    pos = lib["spacing"] * (1 + np.arange(n_loci, dtype=np.int64))
    samples = {name: _sample_reads(rng, vaf[name], lib) for name in config["samples"]}
    return {"chrom": chrom, "pos": pos, "ref": BASES[ref_i], "alt": BASES[alt_i],
            "truth": np.asarray(names)[kind], "samples": samples}
