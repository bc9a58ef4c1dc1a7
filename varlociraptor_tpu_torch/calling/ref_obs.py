"""Interop reader for the REFERENCE's preprocessed observation files.

varlociraptor serializes per-read observations into BCF INFO arrays:
each tag is a bincode byte stream (little endian) packed two bytes per
int value (``preprocessing/mod.rs:818-1038``). This module decodes those
records into our ``ReadObservation``/``Pileup`` model so calling can run
directly on observation BCF/VCF files produced by the reference —
``call variants generic --obs sample=reference_obs.bcf`` just works.

Bincode layouts (bincode 1.x defaults, little endian):
  Vec<T>           u64 count + elements
  enum             u32 variant index (+ payload)
  Option<T>        u8 tag (0 none, 1 some) + payload
  MiniLogProb      enum { F16(u16)=0, F32(f32)=1 }  (utils/mod.rs:448-474)
  BitVec<u8>       u8 0x01 prefix + storage Vec<u8> + u64 nbits
                   (LSB-first within each byte, verified empirically)
"""

from __future__ import annotations

import struct

import numpy as np

from ..evidence.observation import (
    ALT_LOCUS_MAJOR,
    ALT_LOCUS_NONE,
    ALT_LOCUS_SOME,
    Pileup,
    READ_POSITION_MAJOR,
    READ_POSITION_SOME,
    ReadObservation,
    RO_BY_NAME,
    RO_NONE,
    STRAND_BOTH,
    STRAND_FORWARD,
    STRAND_NONE,
    STRAND_REVERSE,
    set_prob_mapping,
    set_prob_overlap,
)
from ..calling.variants import collect_variants

# reference enum orders (read_observation.rs:51-57,125-129,213-217)
_STRAND = {0: STRAND_FORWARD, 1: STRAND_REVERSE, 2: STRAND_BOTH, 3: STRAND_NONE}
_READ_POSITION = {0: READ_POSITION_MAJOR, 1: READ_POSITION_SOME}
_ALT_LOCUS = {0: ALT_LOCUS_MAJOR, 1: ALT_LOCUS_SOME, 2: ALT_LOCUS_NONE}
# bio_types::sequence::SequenceReadPairOrientation variant order; only the
# F1R2/F2R1/None distinction is consumed downstream (bias model + the
# nonstandard-alignment filter), the middle variants all map to
# "nonstandard".
_READ_ORIENTATION = {
    0: RO_BY_NAME["F1R2"],
    1: RO_BY_NAME["F2R1"],
    2: RO_BY_NAME["R1F2"],
    3: RO_BY_NAME["R2F1"],
    4: RO_BY_NAME["F1F2"],
    5: RO_BY_NAME["F2F1"],
    6: RO_BY_NAME["R1R2"],
    7: RO_BY_NAME["R2R1"],
    8: RO_NONE,
}

_OBS_TAGS = ("PROB_MAPPING", "PROB_REF", "PROB_ALT", "STRAND")


class _ByteReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _unpack(self, fmt, size):
        v = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += size
        return v

    def u8(self):
        return self._unpack("<B", 1)

    def u32(self):
        return self._unpack("<I", 4)

    def u64(self):
        return self._unpack("<Q", 8)

    def i8(self):
        return self._unpack("<b", 1)

    def f32(self):
        return self._unpack("<f", 4)

    def f16(self):
        return self._unpack("<e", 2)


def _u16s_to_bytes(vals) -> bytes:
    return b"".join(struct.pack("<H", int(v) & 0xFFFF) for v in vals)


def _mini_logprob(r: _ByteReader) -> float:
    tag = r.u32()
    if tag == 0:
        return float(r.f16())
    if tag == 1:
        return float(r.f32())
    raise ValueError(f"bad MiniLogProb tag {tag}")


def _vec(r: _ByteReader, elem):
    return [elem(r) for _ in range(r.u64())]


def _option(r: _ByteReader, elem):
    return elem(r) if r.u8() == 1 else None


def _bitvec(r: _ByteReader):
    # observed layout of the reference's serialized BitVec<u8>:
    # u8 0x01 prefix, u64 storage byte count, storage, u64 nbits;
    # bits are LSB-first within each byte (verified against PAIRED all-ones
    # with 102 reads -> 12x 0xff + 0x3f)
    prefix = r.u8()
    if prefix != 1:  # pragma: no cover - unknown future layout
        raise ValueError(f"unexpected BitVec prefix {prefix}")
    storage = bytes(r.u8() for _ in range(r.u64()))
    nbits = r.u64()
    return [bool((storage[i // 8] >> (i % 8)) & 1) for i in range(nbits)]


def _info_ints(rec, tag):
    raw = rec.info_get(tag)
    if raw is None or raw is True:
        return None
    if isinstance(raw, (int, float)):
        return [int(raw)]
    if isinstance(raw, str):
        return [int(x) for x in raw.split(",")]
    return [int(x) for x in raw]


def is_reference_observation_record(rec) -> bool:
    return all(_info_ints(rec, t) is not None for t in _OBS_TAGS)


def decode_reference_observations(rec) -> Pileup:
    """One candidate record with embedded observations -> Pileup."""

    def field(tag, parse, allow_missing=False):
        vals = _info_ints(rec, tag)
        if vals is None:
            if allow_missing:
                return None
            raise ValueError(f"missing observation tag {tag}")
        return parse(_ByteReader(_u16s_to_bytes(vals)))

    def prob_field(tag, allow_missing=False):
        """Vec<MiniLogProb> in current snapshots; very old snapshots store
        plain Vec<f64> or Vec<f32> — try each layout."""
        vals = _info_ints(rec, tag)
        if vals is None:
            if allow_missing:
                return None
            raise ValueError(f"missing observation tag {tag}")
        data = _u16s_to_bytes(vals)
        for parse_elem, width in (
            (_mini_logprob, None),
            (lambda r: r._unpack("<d", 8), 8),
            (lambda r: r._unpack("<f", 4), 4),
        ):
            r = _ByteReader(data)
            try:
                n = r.u64()
                if width is not None and not (
                    n * width <= len(data) - 8 <= n * width + 1
                ):
                    continue
                out = [parse_elem(r) for _ in range(n)]
                # log-probs: <= ~0, -inf allowed, NaN not
                if all(v <= 1e-3 and not (v != v) for v in out):
                    return out
            except (struct.error, ValueError):
                continue
        raise ValueError(f"cannot decode observation tag {tag}")

    ids = field("FRAGMENT_ID", lambda r: _vec(r, lambda rr: _option(rr, _ByteReader.u64)), allow_missing=True)
    pm = prob_field("PROB_MAPPING")
    pr = prob_field("PROB_REF")
    pa = prob_field("PROB_ALT")
    pme = prob_field("PROB_MISSED_ALLELE")
    psa = prob_field("PROB_SAMPLE_ALT")
    pdo = prob_field("PROB_DOUBLE_OVERLAP")
    phb = prob_field("PROB_HIT_BASE", allow_missing=True)
    strand = field("STRAND", lambda r: _vec(r, _ByteReader.u32))
    ro = field("READ_ORIENTATION", lambda r: _vec(r, _ByteReader.u32))
    rp = field("READ_POSITION", lambda r: _vec(r, _ByteReader.u32), allow_missing=True)
    sc = field("SOFTCLIPPED", _bitvec)
    paired = field("PAIRED", _bitvec, allow_missing=True)
    pha = field(
        "PROB_HOMOPOLYMER_ARTIFACT_OBSERVABLE",
        lambda r: _vec(r, lambda rr: _option(rr, _mini_logprob)),
        allow_missing=True,
    )
    phv = field(
        "PROB_HOMOPOLYMER_VARIANT_OBSERVABLE",
        lambda r: _vec(r, lambda rr: _option(rr, _mini_logprob)),
        allow_missing=True,
    )
    if pha is None:
        # pre-rename snapshots (older tag names + layouts); best-effort —
        # undecodable layouts degrade to "no homopolymer info"
        try:
            pha = field(
                "PROB_ARTIFACT_HOMOPOLYMER_ERROR",
                lambda r: _vec(r, lambda rr: _option(rr, _mini_logprob)),
                allow_missing=True,
            )
        except (ValueError, struct.error):
            pha = None
    if phv is None:
        try:
            phv = field(
                "PROB_WILDTYPE_HOMOPOLYMER_ERROR",
                lambda r: _vec(r, lambda rr: _option(rr, _mini_logprob)),
                allow_missing=True,
            )
        except (ValueError, struct.error):
            phv = None
    if (pha is None) != (phv is None):
        pha = phv = None
    hil = field(
        "HOMOPOLYMER_INDEL_LEN",
        lambda r: _vec(r, lambda rr: _option(rr, _ByteReader.i8)),
        allow_missing=True,
    )
    mm = field("IS_MAX_MAPQ", _bitvec, allow_missing=True)
    al = field("ALT_LOCUS", lambda r: _vec(r, _ByteReader.u32), allow_missing=True)
    ta = field(
        "THIRD_ALLELE_EVIDENCE",
        lambda r: _vec(r, lambda rr: _option(rr, _ByteReader.u32)),
        allow_missing=True,
    )

    n = len(pm)
    observations = []
    for i in range(n):
        o = ReadObservation()
        set_prob_mapping(o, min(pm[i], 0.0))
        o.prob_ref = pr[i]
        o.prob_alt = pa[i]
        o.prob_missed_allele = pme[i]
        o.prob_sample_alt = min(psa[i], 0.0)
        set_prob_overlap(o, min(pdo[i], 0.0))
        o.prob_hit_base = phb[i] if phb else 0.0
        o.strand = _STRAND.get(strand[i], STRAND_NONE)
        o.read_orientation = _READ_ORIENTATION.get(ro[i], RO_NONE)
        o.read_position = (
            _READ_POSITION.get(rp[i], READ_POSITION_SOME)
            if rp
            else READ_POSITION_SOME
        )
        o.softclipped = sc[i] if i < len(sc) else False
        o.paired = paired[i] if paired and i < len(paired) else True
        o.prob_observable_at_homopolymer_artifact = pha[i] if pha else None
        o.prob_observable_at_homopolymer_variant = phv[i] if phv else None
        o.homopolymer_indel_len = hil[i] if hil else None
        o.is_max_mapq = mm[i] if mm and i < len(mm) else True
        o.alt_locus = _ALT_LOCUS.get(al[i], ALT_LOCUS_NONE) if al else ALT_LOCUS_NONE
        o.fragment_id = ids[i] if ids else None
        o.third_allele_evidence = ta[i] if ta else None
        observations.append(o)
    return Pileup(read_observations=observations)


class ReferenceObservationReader:
    """Iterate (VariantInfo, Pileup) from a reference observation BCF/VCF."""

    def __init__(self, path, sample_name: str | None = None):
        from ..io.vcf import open_variant_file

        self.path = path
        self._reader = open_variant_file(path)
        self.header = {"format_version": "reference-bcf", "options": {}}
        self.sample_name = sample_name or "sample"

    def __iter__(self):
        for rec in self._reader:
            infos = collect_variants(rec)
            if not infos:
                continue
            pileup = decode_reference_observations(rec)
            for info in infos:
                yield info, pileup

    def close(self):
        pass


class _ChainedReader:
    def __init__(self, readers):
        self.readers = readers
        self.header = readers[0].header
        self.sample_name = getattr(readers[0], "sample_name", "sample")

    def __iter__(self):
        for r in self.readers:
            yield from r

    def close(self):
        for r in self.readers:
            r.close()


def open_observations(path, sample_name: str | None = None):
    """JSON-lines observation file or a reference observation BCF/VCF.
    A comma-separated list of paths chains region shards in order."""
    if isinstance(path, str) and "," in path:
        return _ChainedReader(
            [open_observations(p, sample_name) for p in path.split(",")]
        )
    from ..io.vcf import open_variant_file

    head = open(path, "rb").read(4)
    if head[:2] == b"\x1f\x8b":
        # gzip can wrap EITHER a BCF/VCF or our JSON-lines observation
        # format (.jsonl.gz) — sniff the decompressed payload, don't
        # assume binary means variant file
        import gzip as _gz

        try:
            with _gz.open(path, "rt") as f:
                first = f.readline()
            if first.startswith("{"):
                from .observations import ObservationReader

                return ObservationReader(path)
        except (OSError, UnicodeDecodeError):  # a BGZF BCF is binary
            pass
    looks_binary = head[:3] == b"BCF" or head[:2] == b"\x1f\x8b"
    if not looks_binary:
        try:
            text = open(path, "rt", errors="strict").readline()
            if text.startswith("{"):
                from .observations import ObservationReader

                return ObservationReader(path)
        except UnicodeDecodeError:
            pass
    if not looks_binary and not head.startswith(b"##"):
        from .observations import ObservationReader

        return ObservationReader(path)
    # VCF/BCF: check the first record for observation tags
    probe = open_variant_file(path)
    for rec in probe:
        if is_reference_observation_record(rec):
            return ReferenceObservationReader(path, sample_name)
        break
    raise ValueError(
        f"{path} is neither a JSON-lines observation file nor a "
        "varlociraptor observation BCF"
    )


# ---------------------------------------------------------------------------
# Writing (observation format v15, preprocessing/mod.rs:921-1038)
# ---------------------------------------------------------------------------

# inverse enum maps (read_observation.rs:51-57,125-129,213-217)
_STRAND_INV = {v: k for k, v in _STRAND.items()}
_READ_POSITION_INV = {v: k for k, v in _READ_POSITION.items()}
_ALT_LOCUS_INV = {v: k for k, v in _ALT_LOCUS.items()}
_READ_ORIENTATION_INV = {v: k for k, v in _READ_ORIENTATION.items()}

OBSERVATION_FORMAT_VERSION_REF = "15"


class _ByteWriter:
    def __init__(self):
        self.parts = []

    def _pack(self, fmt, v):
        self.parts.append(struct.pack(fmt, v))

    def u8(self, v):
        self._pack("<B", v)

    def u32(self, v):
        self._pack("<I", v)

    def u64(self, v):
        self._pack("<Q", v)

    def i8(self, v):
        self._pack("<b", v)

    def f32(self, v):
        self._pack("<f", v)

    def f16(self, v):
        self._pack("<e", np.float16(v))

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def _w_mini_logprob(w: _ByteWriter, v: float):
    """MiniLogProb::new (utils/mod.rs:456-466): f16 iff prob < -10 and the
    f16 round-trip preserves the integer part."""
    import math as _math

    v = float(v)
    half = float(np.float16(v))
    use16 = v < -10.0 and (
        (v == -np.inf and half == -np.inf)
        or (np.isfinite(half) and _math.floor(half) == _math.floor(v))
    )
    if use16:
        w.u32(0)
        w.f16(v)
    else:
        w.u32(1)
        w.f32(v)


def _w_vec(w: _ByteWriter, items, elem):
    w.u64(len(items))
    for it in items:
        elem(w, it)


def _w_option(w: _ByteWriter, v, elem):
    if v is None:
        w.u8(0)
    else:
        w.u8(1)
        elem(w, v)


def _w_bitvec(w: _ByteWriter, bools):
    w.u8(1)
    nbytes = (len(bools) + 7) // 8
    storage = bytearray(nbytes)
    for i, b in enumerate(bools):
        if b:
            storage[i // 8] |= 1 << (i % 8)
    w.u64(nbytes)
    for byte in storage:
        w.u8(byte)
    w.u64(len(bools))


def _bytes_to_u16_csv(data: bytes) -> str:
    if len(data) % 2:
        data += b"\x00"
    return ",".join(
        str(struct.unpack_from("<H", data, i)[0]) for i in range(0, len(data), 2)
    )


def encode_reference_observations(pileup) -> dict:
    """Pileup -> {INFO tag: comma-joined u16 ints} in format v15."""
    obs = pileup.read_observations

    def packed(build):
        w = _ByteWriter()
        build(w)
        return _bytes_to_u16_csv(w.bytes())

    from ..evidence.observation import READ_POSITION_MAJOR

    info = {}
    info["FRAGMENT_ID"] = packed(
        lambda w: _w_vec(
            w,
            [o.fragment_id for o in obs],
            lambda ww, v: _w_option(ww, v, _ByteWriter.u64),
        )
    )
    for tag, get in (
        # the reference serializes via the prob_mapping() ACCESSOR
        # (read_observation.rs:401 = prob_mapping_adj.unwrap_or(raw)), i.e.
        # the MAPQ-ADJUSTED value — calling never re-adjusts
        ("PROB_MAPPING", lambda o: o.eff_prob_mapping()),
        ("PROB_REF", lambda o: o.prob_ref),
        ("PROB_ALT", lambda o: o.prob_alt),
        ("PROB_MISSED_ALLELE", lambda o: o.prob_missed_allele),
        ("PROB_SAMPLE_ALT", lambda o: o.prob_sample_alt),
        ("PROB_DOUBLE_OVERLAP", lambda o: o.prob_double_overlap),
    ):
        info[tag] = packed(
            lambda w, g=get: _w_vec(w, [g(o) for o in obs], _w_mini_logprob)
        )
    info["STRAND"] = packed(
        lambda w: _w_vec(
            w, [_STRAND_INV.get(o.strand, 3) for o in obs], _ByteWriter.u32
        )
    )
    info["READ_ORIENTATION"] = packed(
        lambda w: _w_vec(
            w,
            [_READ_ORIENTATION_INV.get(o.read_orientation, 8) for o in obs],
            _ByteWriter.u32,
        )
    )
    info["SOFTCLIPPED"] = packed(
        lambda w: _w_bitvec(w, [bool(o.softclipped) for o in obs])
    )
    info["PAIRED"] = packed(lambda w: _w_bitvec(w, [bool(o.paired) for o in obs]))
    info["READ_POSITION"] = packed(
        lambda w: _w_vec(
            w,
            [0 if o.read_position == READ_POSITION_MAJOR else 1 for o in obs],
            _ByteWriter.u32,
        )
    )
    info["PROB_HIT_BASE"] = packed(
        lambda w: _w_vec(w, [o.prob_hit_base for o in obs], _w_mini_logprob)
    )
    info["IS_MAX_MAPQ"] = packed(
        lambda w: _w_bitvec(w, [bool(o.is_max_mapq) for o in obs])
    )
    info["ALT_LOCUS"] = packed(
        lambda w: _w_vec(
            w, [_ALT_LOCUS_INV.get(o.alt_locus, 2) for o in obs], _ByteWriter.u32
        )
    )
    info["THIRD_ALLELE_EVIDENCE"] = packed(
        lambda w: _w_vec(
            w,
            [o.third_allele_evidence for o in obs],
            lambda ww, v: _w_option(ww, None if v is None else int(v), _ByteWriter.u32),
        )
    )
    if any(o.prob_observable_at_homopolymer_artifact is not None for o in obs):
        info["PROB_HOMOPOLYMER_ARTIFACT_OBSERVABLE"] = packed(
            lambda w: _w_vec(
                w,
                [o.prob_observable_at_homopolymer_artifact for o in obs],
                lambda ww, v: _w_option(ww, v, _w_mini_logprob),
            )
        )
        info["PROB_HOMOPOLYMER_VARIANT_OBSERVABLE"] = packed(
            lambda w: _w_vec(
                w,
                [o.prob_observable_at_homopolymer_variant for o in obs],
                lambda ww, v: _w_option(ww, v, _w_mini_logprob),
            )
        )
        info["HOMOPOLYMER_INDEL_LEN"] = packed(
            lambda w: _w_vec(
                w,
                [o.homopolymer_indel_len for o in obs],
                lambda ww, v: _w_option(ww, None if v is None else int(v), _ByteWriter.i8),
            )
        )
    return info


_OBS_INFO_HEADER_TAGS = (
    "FRAGMENT_ID", "PROB_MAPPING", "PROB_REF", "PROB_ALT",
    "PROB_MISSED_ALLELE", "PROB_SAMPLE_ALT", "PROB_DOUBLE_OVERLAP",
    "STRAND", "READ_ORIENTATION", "SOFTCLIPPED",
    # vestigial in the reference (header-declared at preprocessing/mod.rs:147
    # but never written or read); declared for header byte-compat
    "ALT_INDEL_OPERATIONS",
    "PAIRED", "READ_POSITION",
    "PROB_HIT_BASE", "IS_MAX_MAPQ", "ALT_LOCUS", "THIRD_ALLELE_EVIDENCE",
    "PROB_HOMOPOLYMER_ARTIFACT_OBSERVABLE",
    "PROB_HOMOPOLYMER_VARIANT_OBSERVABLE", "HOMOPOLYMER_INDEL_LEN",
)


class ReferenceObservationWriter:
    """Write preprocess output in the reference's observation BCF/VCF format
    (v15) so the wider varlociraptor ecosystem can consume it.  Same
    interface as calling.observations.ObservationWriter."""

    def __init__(self, path, sample_name: str, options: dict | None = None):
        import json as _json

        from ..io.vcf import open_variant_writer

        self.path = path
        header = [
            f"##varlociraptor_observation_format_version={OBSERVATION_FORMAT_VERSION_REF}",
            f"##varlociraptor_sample_name={sample_name}",
            "##varlociraptor_preprocess_args="
            + _json.dumps(options or {}, default=str).replace("\n", " "),
            '##INFO=<ID=SVLEN,Number=A,Type=Integer,Description="SV length">',
            '##INFO=<ID=END,Number=1,Type=Integer,Description="SV end">',
            '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">',
            '##INFO=<ID=EVENT,Number=1,Type=String,Description="Haplotype event id">',
            '##INFO=<ID=MATEID,Number=.,Type=String,Description="Breakend mate id">',
            '##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise SV">',
            '##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS">',
            '##INFO=<ID=CIEND,Number=2,Type=Integer,Description="Confidence interval around END">',
        ] + [
            f'##INFO=<ID={t},Number=.,Type=Integer,Description="Varlociraptor observations">'
            for t in _OBS_INFO_HEADER_TAGS
        ]
        self._writer = open_variant_writer(path, sample_names=[], header_lines=header)
        self._writer.__enter__()

    def write_record(self, variant, pileup, aux: dict | None = None):
        from ..io.vcf import VcfRecord

        info = {}
        kind = variant.kind
        if kind in ("deletion", "insertion", "inversion", "duplication"):
            # symbolic-compatible SV annotations so collect_variants
            # round-trips (utils/collect_variants.rs:44-304)
            svlen = variant.svlen or abs(
                len(variant.alt_allele) - len(variant.ref_allele)
            )
            info["SVLEN"] = str(-svlen if kind == "deletion" else svlen)
            info["SVTYPE"] = {
                "deletion": "DEL",
                "insertion": "INS",
                "inversion": "INV",
                "duplication": "DUP",
            }[kind]
            if kind in ("inversion", "duplication") and svlen:
                # INV/DUP need END (1-based inclusive) or the read-back
                # collect_variants drops the record silently
                info["END"] = str(variant.pos + svlen)
        rec_id = "."
        hap = variant.haplotype
        if hap is not None:
            # internal identifiers carry a discriminating prefix
            # (haplotype_identifier): EVENT-derived ids round-trip as the
            # bare EVENT name; MATEID-derived ids restore ID/MATEID so the
            # read-back haplotype_identifier reconstructs the same key
            # (writing the prefixed string verbatim would re-prefix on
            # every round trip and break cross-file breakend grouping)
            hap = str(hap)
            if hap.startswith("event:"):
                info["EVENT"] = hap[len("event:") :]
            elif hap.startswith("mates:"):
                ids = hap[len("mates:") :].split(",")
                if len(ids) == 2:
                    rec_id = ids[0] if kind == "breakend" else "."
                    info["MATEID"] = ids[1] if rec_id == ids[0] else ids[0]
            else:
                info["EVENT"] = hap
        if not variant.precise:
            info["IMPRECISE"] = True
            if variant.cipos is not None:
                info["CIPOS"] = f"{variant.cipos[0]},{variant.cipos[1]}"
            if variant.ciend is not None:
                info["CIEND"] = f"{variant.ciend[0]},{variant.ciend[1]}"
        if aux:
            info.update({k: v for k, v in aux.items()})
        info.update(encode_reference_observations(pileup))
        alt = variant.alt_allele
        if kind == "breakend" and variant.spec:
            alt = variant.spec
        self._writer.write(
            VcfRecord(
                chrom=variant.chrom,
                pos=variant.pos,
                id=rec_id,
                ref=variant.ref_allele,
                alts=[alt],
                info=info,
            )
        )

    def close(self):
        self._writer.__exit__(None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
