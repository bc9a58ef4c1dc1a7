"""The call cell's inputs: per-sample read observations at candidate loci,
drawn from the seed, and their observation files.

The draw follows the configuration's library and candidates (its
``call_input`` block): candidates one per ``spacing`` bases of its
``genome_len``, a share of them
germline heterozygous (allele frequency 0.5 in both samples), a share
somatic heterozygous (0.5 in the tumor's cells, so ``purity`` x 0.5 in the
tumor sample), the rest decoys (0 in both).  Each sample's depth at a locus
is Poisson(``coverage``).  A read carries the allele of its haplotype; its
base there has a PHRED quality drawn from N(``phred_mean``, ``phred_sd``),
rounded and clipped to [``phred_min``, ``phred_max``], and is replaced by one
of the three other bases with probability ``base_error``.  Its evidence is
what that base says: P(base | allele) = 1 - e where the base is the allele,
e / 3 where it is not (e = 10^(-q/10)).  Strand and pair orientation are
even coin flips; ``max_mapq_share`` of the reads have the library's top
mapping quality; every read maps with probability ``prob_mapping``.

:func:`draw` makes the columns as plain numpy arrays with names of their
own (what the reference reads); :func:`write_files` serialises them with the
program's observation writer (what the program reads).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

STRAND_FORWARD, STRAND_REVERSE = 1, 2
ORIENT_F1R2, ORIENT_F2R1 = 1, 2
BASES = np.array(list("ACGT"))


def _f16(x):
    return np.asarray(x, dtype=np.float64).astype(np.float16)


def _sample_reads(rng, vaf, lib):
    """One sample's reads at every locus: (counts, {column: array})."""
    counts = rng.poisson(lib["coverage"], len(vaf))
    n = int(counts.sum())
    is_alt = rng.random(n) < np.repeat(vaf, counts)
    q = np.clip(np.rint(rng.normal(lib["phred_mean"], lib["phred_sd"], n)),
                lib["phred_min"], lib["phred_max"])
    e = 10.0 ** (-q / 10.0)
    # a substitution shows one of the three other bases: the other allele
    # with one chance in three, a third base otherwise
    sub = rng.random(n) < lib["base_error"]
    other = rng.random(n) < 1.0 / 3.0
    shows_alt = np.where(sub, ~is_alt & other, is_alt)
    shows_ref = np.where(sub, is_alt & other, ~is_alt)
    hit, miss = np.log1p(-e), np.log(e / 3.0)
    cols = {
        "prob_mapping": _f16(np.full(n, math.log(lib["prob_mapping"]))),
        "prob_alt": _f16(np.where(shows_alt, hit, miss)),
        "prob_ref": _f16(np.where(shows_ref, hit, miss)),
        "prob_missed_allele": _f16(np.full(n, math.log(0.5))),
        "prob_sample_alt": _f16(np.zeros(n)),
        "prob_double_overlap": _f16(np.full(n, -np.inf)),
        "prob_hit_base": _f16(np.full(n, math.log(1.0 / lib["read_len"]))),
        "strand": rng.integers(STRAND_FORWARD, STRAND_REVERSE + 1, n).astype(np.uint8),
        "orientation": rng.integers(ORIENT_F1R2, ORIENT_F2R1 + 1, n).astype(np.uint8),
        "max_mapq": rng.random(n) < lib["max_mapq_share"],
        "paired": np.ones(n, bool),
        "read_position_major": np.zeros(n, bool),
        "softclipped": np.zeros(n, bool),
    }
    return counts, cols


def draw(config, seed, chrom="chr1"):
    """{"chrom", "pos" (0-based), "ref", "alt", "truth", "samples": {name:
    (counts, columns)}} of the candidates of the configuration's
    ``genome_len`` bases, from the seed."""
    lib = config["call_input"]
    n_loci = int(config["genome_len"] // lib["spacing"])
    rng = np.random.default_rng(seed)
    mix = lib["mix"]
    kind = rng.choice(len(mix), n_loci, p=[mix[k] for k in mix])
    names = list(mix)
    het = 0.5
    vaf = {
        "tumor": np.select([kind == names.index("germline_het"),
                            kind == names.index("somatic")],
                           [het, config["purity"] * het], 0.0),
        "normal": np.where(kind == names.index("germline_het"), het, 0.0),
    }
    ref_i = rng.integers(0, 4, n_loci)
    alt_i = (ref_i + rng.integers(1, 4, n_loci)) % 4
    pos = lib["spacing"] * (1 + np.arange(n_loci, dtype=np.int64))
    samples = {name: _sample_reads(rng, vaf[name], lib) for name in config["samples"]}
    return {"chrom": chrom, "pos": pos, "ref": BASES[ref_i], "alt": BASES[alt_i],
            "truth": np.asarray(names)[kind], "samples": samples}


def select(inputs, loci):
    """The inputs of the loci at the sorted indices ``loci`` alone."""
    out = dict(inputs, pos=inputs["pos"][loci], ref=inputs["ref"][loci],
               alt=inputs["alt"][loci], truth=inputs["truth"][loci], samples={})
    for name, (counts, cols) in inputs["samples"].items():
        off = np.concatenate([[0], np.cumsum(counts)])
        rows = np.concatenate([np.arange(off[i], off[i + 1]) for i in loci])
        out["samples"][name] = (counts[loci], {k: v[rows] for k, v in cols.items()})
    return out


def write_files(inputs, out_dir):
    """One observation file per sample (the program's binary format, written
    by its ``ObservationWriter`` in 1024-locus windows); {sample: path}."""
    from varlociraptor_tpu_torch.calling.observations import ObservationWriter, ObsColumns
    from varlociraptor_tpu_torch.calling.variants import VariantInfo
    from varlociraptor_tpu_torch.evidence import observation as ob
    from varlociraptor_tpu_torch.ops import compact_obs as co

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = [VariantInfo(kind="snv", chrom=inputs["chrom"], pos=int(p), ref_allele=str(r),
                            alt_allele=str(a))
                for p, r, a in zip(inputs["pos"], inputs["ref"], inputs["alt"])]
    strand = np.zeros(256, np.uint8)
    strand[[STRAND_FORWARD, STRAND_REVERSE]] = ob.STRAND_FORWARD, ob.STRAND_REVERSE
    orient = np.zeros(256, np.uint8)
    orient[[ORIENT_F1R2, ORIENT_F2R1]] = ob.RO_F1R2, ob.RO_F2R1
    paths = {}
    for name, (counts, c) in inputs["samples"].items():
        n = len(c["prob_alt"])
        f16 = np.zeros((n, co.N_CF), np.float16)
        for col, key in ((co.CF_PM, "prob_mapping"), (co.CF_PA, "prob_alt"),
                         (co.CF_PR, "prob_ref"), (co.CF_PME, "prob_missed_allele"),
                         (co.CF_PSA, "prob_sample_alt"), (co.CF_PDO, "prob_double_overlap"),
                         (co.CF_PHB, "prob_hit_base")):
            f16[:, col] = c[key]
        f16[:, co.CF_PHA] = np.nan
        f16[:, co.CF_PHV] = np.nan
        u8 = np.zeros((n, co.N_CU), np.uint8)
        u8[:, co.CU_STRAND] = strand[c["strand"]]
        u8[:, co.CU_RO] = orient[c["orientation"]]
        u8[:, co.CU_FLAGS] = (np.where(c["paired"], co.FLAG_PAIRED, 0)
                              | np.where(c["max_mapq"], co.FLAG_IS_MAX_MAPQ, 0)
                              | np.where(c["read_position_major"], co.FLAG_READ_POSITION_MAJOR, 0)
                              | np.where(c["softclipped"], co.FLAG_SOFTCLIPPED, 0))
        u8[:, co.CU_ALT_LOCUS] = ob.ALT_LOCUS_NONE
        cols = ObsColumns(f16, u8, np.full(n, ob.HOMOPOLYMER_NONE, np.int8),
                          np.full(n, -1, np.int16), np.full(n, -1, np.int64))
        off = np.concatenate([[0], np.cumsum(counts)])
        path = out_dir / f"{name}.obs"
        with ObservationWriter(str(path), name) as w:
            for s in range(0, len(variants), 1024):
                e = min(len(variants), s + 1024)
                w.write_window(variants[s:e], counts[s:e],
                               cols.slice(int(off[s]), int(off[e])), counts[s:e])
        paths[name] = str(path)
    return paths
