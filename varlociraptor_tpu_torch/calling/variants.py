"""Candidate record -> typed variants.

Port of ``collect_variants`` (``src/utils/collect_variants.rs:44-304``):
SNV/MNV/DEL/INS/INV/DUP/BND/REP/None/<METH> classification incl. SVTYPE/SVLEN/END
conventions, ``<*>`` dummy alleles, IMPRECISE skipping, per-variant prior INFO
fields, and haplotype identifiers (EVENT tag / MATEID pairs).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..io.vcf import VcfRecord


@dataclass
class VariantInfo:
    kind: str  # snv|mnv|none|deletion|insertion|inversion|duplication|replacement|breakend|methylation
    chrom: str
    pos: int  # 0-based
    ref_allele: str
    alt_allele: str
    # type payload
    alt_base: str = ""
    alt_seq: str = ""
    svlen: int = 0
    spec: str = ""  # breakend spec
    precise: bool = True
    haplotype: str | None = None
    cipos: tuple | None = None  # raw candidate CIPOS (lo, hi) when imprecise
    ciend: tuple | None = None
    heterozygosity: float | None = None
    somatic_effective_mutation_rate: float | None = None
    aux_info: dict | None = None

    @property
    def variant_type(self) -> str:
        return self.kind

def haplotype_identifier(rec: VcfRecord):
    """HaplotypeIdentifier::from (variants/model/mod.rs:88-134): EVENT tag,
    else sorted (ID, MATEID) pair for breakends."""
    event = rec.info_get("EVENT")
    if event and event is not True:
        return f"event:{event}"
    if rec.info_get("SVTYPE") == "BND":
        mateid = rec.info_get("MATEID")
        if mateid and rec.id and rec.id != ".":
            pair = sorted([rec.id, str(mateid)])
            return "mates:" + ",".join(pair)
    return None


def collect_variants(rec: VcfRecord, skip_imprecise: bool = True) -> list[VariantInfo]:
    imprecise = rec.info_get("IMPRECISE") is True
    svtype = rec.info_get("SVTYPE")
    pos = rec.pos
    haplotype = haplotype_identifier(rec)

    def svlens():
        raw = rec.info_get("SVLEN")
        if raw is None:
            return None
        out = []
        for x in str(raw).split(","):
            try:
                out.append(abs(int(x)))
            except ValueError:
                out.append(None)
        return out

    def end():
        raw = rec.info_get("END")
        if raw is None:
            return None
        return int(raw) - 1

    def get_prior(key):
        raw = rec.info_get(key)
        if raw is None or raw is True:
            return None
        try:
            return float(str(raw).split(",")[0])
        except ValueError:
            return None

    het = get_prior("HETEROZYGOSITY")
    som = get_prior("SOMATIC_EFFECTIVE_MUTATION_RATE")

    def get_ci(key):
        # VariantPrecision::try_from (variants/model/mod.rs:183-239):
        # CIPOS/CIEND kept as the raw candidate integer pair and written
        # back verbatim on output records (calling/variants/mod.rs:162-176)
        raw = rec.info_get(key)
        if raw is None or raw is True:
            return None
        parts = str(raw).split(",")
        if len(parts) != 2:
            return None
        try:
            return (int(parts[0]), int(parts[1]))
        except ValueError:
            return None

    cipos = get_ci("CIPOS") if imprecise else None
    ciend = get_ci("CIEND") if imprecise else None

    def mk(kind, alt_allele, **kw):
        return VariantInfo(
            kind=kind,
            chrom=rec.chrom,
            pos=pos,
            ref_allele=rec.ref,
            alt_allele=alt_allele,
            precise=not imprecise,
            haplotype=haplotype,
            heterozygosity=het,
            somatic_effective_mutation_rate=som,
            cipos=cipos,
            ciend=ciend,
            **kw,
        )

    def is_valid_insertion(ref, alt):
        return alt == "<INS>" or (
            len(ref) < len(alt) and alt.startswith(ref) and len(ref) == 1
        )

    def is_valid_deletion(ref, alt):
        return alt == "<DEL>" or (
            len(ref) > len(alt) and ref.startswith(alt) and len(alt) == 1
        )

    variants: list[VariantInfo] = []
    if skip_imprecise and imprecise and svtype != "BND":
        return variants

    if svtype:
        ref = rec.ref
        if svtype == "INV":
            e = end()
            if len(rec.alts) == 1 and e is not None:
                variants.append(mk("inversion", rec.alts[0], svlen=e + 1 - pos))
        elif svtype == "DUP":
            e = end()
            if len(rec.alts) == 1 and e is not None:
                variants.append(mk("duplication", rec.alts[0], svlen=e + 1 - pos))
        elif svtype == "BND":
            if haplotype is not None:
                for alt in rec.alts:
                    variants.append(mk("breakend", alt, spec=alt))
        elif svtype == "INS":
            alt = rec.alts[0]
            if alt != "<INS>" and is_valid_insertion(ref, alt):
                variants.append(mk("insertion", alt, alt_seq=alt[len(ref) :]))
        elif svtype == "DEL":
            sl = svlens()
            e = end()
            if sl and sl[0] is not None:
                svlen = sl[0]
            elif e is not None:
                svlen = e - (pos + 1)
            else:
                raise ValueError("missing SVLEN or END for DEL")
            if svlen > 0:
                alt = rec.alts[0]
                if alt == "<DEL>" or is_valid_deletion(ref, alt):
                    variants.append(mk("deletion", alt, svlen=svlen))
        return variants

    ref = rec.ref
    sl = svlens()
    for i, alt in enumerate(rec.alts):
        if alt == "<*>":
            variants.append(mk("none", alt))
        elif alt == "<DEL>":
            if sl and sl[i] is not None:
                variants.append(mk("deletion", alt, svlen=sl[i]))
        elif alt == "<METH>":
            variants.append(mk("methylation", alt))
        elif alt.startswith("<"):
            continue
        elif len(alt) == 1 and len(ref) == 1:
            variants.append(mk("snv", alt, alt_base=alt))
        elif len(alt) == len(ref):
            variants.append(mk("mnv", alt, alt_seq=alt))
        elif is_valid_deletion(ref, alt):
            variants.append(mk("deletion", alt, svlen=len(ref) - len(alt)))
        elif is_valid_insertion(ref, alt):
            variants.append(mk("insertion", alt, alt_seq=alt[len(ref) :]))
        else:
            variants.append(mk("replacement", alt, alt_seq=alt))
    return variants
