"""Observation file formats (the pipeline's checkpoint artifact).

The reference serializes per-read observations into BCF INFO fields
(bincode + f16, ``src/calling/variants/preprocessing/mod.rs:921-1038``,
format version 15).  We ship two self-describing formats:

* ``vlt-tpu-2`` (DEFAULT, binary-columnar): framed chunks of ~1024 records —
  a zlib'd JSON metadata block (variant columns) plus raw numpy payloads in
  the compact wire layout of ``ops.compact_obs`` (f16 log-probs + u8
  categoricals).  A chunk decodes into flat columns with two ``frombuffer``
  calls, so the call pipeline never builds per-read Python objects; this is
  the host side of SURVEY §7.3's "keep the chips fed" feed path.
* ``vlt-tpu-1`` (JSON-lines, ``VLT_OBS_FORMAT=jsonl``): one gzip-able JSON
  record per locus carrying the same 20 per-read fields (f16-quantized
  log-probs like the reference's MiniLogProb) — human-inspectable
  interchange format.

Readers auto-detect the format; both expose record iteration (compat) AND
``read_window`` (columnar batches for ``calling.fastcall``).
"""

from __future__ import annotations

import gzip
import json
import math
import os
import struct
import zlib

import numpy as np

from ..evidence.observation import (
    HOMOPOLYMER_NONE,
    Pileup,
    ReadObservation,
)
from ..calling.variants import VariantInfo

OBSERVATION_FORMAT_VERSION = "vlt-tpu-1"  # JSONL; parity target: reference v15
OBSERVATION_FORMAT_VERSION_V2 = "vlt-tpu-2"
MAGIC_V2 = b"VLTOBS2\x00"
CHUNK_RECORDS = 1024

_META_KEYS = (
    "chrom", "pos", "kind", "ref", "alt", "svlen", "precise", "haplotype",
    "het", "som", "cipos", "ciend", "dp", "aux", "counts",
)


def _q(x):
    """f16-quantize a log-prob (MiniLogProb semantics, utils/mod.rs:448-474)."""
    if x is None:
        return None
    if x == -math.inf:
        return "-inf"
    h = float(np.float16(x))
    if math.isinf(h):
        return float(np.float32(x))
    return h


def _unq(x):
    if x is None:
        return None
    if x == "-inf":
        return -math.inf
    return float(x)


def obs_to_dict(o: ReadObservation) -> dict:
    return {
        "f": o.fragment_id,
        # MAPQ adjustment happens at preprocess time, so the *effective*
        # mapping probability is what gets serialized (the reference
        # serializes via the adjusted accessor, preprocessing/mod.rs:921+)
        "pm": _q(o.eff_prob_mapping()),
        "pa": _q(o.prob_alt),
        "pr": _q(o.prob_ref),
        "pme": _q(o.prob_missed_allele),
        "psa": _q(o.prob_sample_alt),
        "pdo": _q(o.prob_double_overlap),
        "phb": _q(o.prob_hit_base),
        "st": o.strand,
        "ro": o.read_orientation,
        "rp": o.read_position,
        "sc": int(o.softclipped),
        "pd": int(o.paired),
        "pha": _q(o.prob_observable_at_homopolymer_artifact),
        "phv": _q(o.prob_observable_at_homopolymer_variant),
        "hil": o.homopolymer_indel_len,
        "mm": int(o.is_max_mapq),
        "al": o.alt_locus,
        "ta": o.third_allele_evidence,
    }


def dict_to_obs(d: dict) -> ReadObservation:
    from ..evidence.observation import set_prob_mapping, set_prob_overlap

    o = ReadObservation()
    set_prob_mapping(o, _unq(d["pm"]))
    o.prob_alt = _unq(d["pa"])
    o.prob_ref = _unq(d["pr"])
    o.prob_missed_allele = _unq(d["pme"])
    o.prob_sample_alt = _unq(d["psa"])
    set_prob_overlap(o, _unq(d["pdo"]))
    o.prob_hit_base = _unq(d["phb"])
    o.strand = d["st"]
    o.read_orientation = d["ro"]
    o.read_position = d["rp"]
    o.softclipped = bool(d["sc"])
    o.paired = bool(d["pd"])
    o.prob_observable_at_homopolymer_artifact = _unq(d["pha"])
    o.prob_observable_at_homopolymer_variant = _unq(d["phv"])
    o.homopolymer_indel_len = d["hil"]
    o.is_max_mapq = bool(d["mm"])
    o.alt_locus = d["al"]
    o.fragment_id = d.get("f")
    o.third_allele_evidence = d["ta"]
    return o


def _variant_to_meta(variant: VariantInfo, pileup: Pileup, aux, meta):
    meta["chrom"].append(variant.chrom)
    meta["pos"].append(variant.pos)
    meta["kind"].append(variant.kind)
    meta["ref"].append(variant.ref_allele)
    meta["alt"].append(variant.alt_allele)
    meta["svlen"].append(variant.svlen)
    meta["precise"].append(bool(variant.precise))
    meta["haplotype"].append(variant.haplotype)
    meta["het"].append(variant.heterozygosity)
    meta["som"].append(variant.somatic_effective_mutation_rate)
    meta["cipos"].append(list(variant.cipos) if variant.cipos else None)
    meta["ciend"].append(list(variant.ciend) if variant.ciend else None)
    meta["dp"].append(pileup.raw_depth)
    meta["aux"].append(aux or None)
    meta["counts"].append(len(pileup.read_observations))


def _meta_to_variant(meta, i) -> VariantInfo:
    v = VariantInfo(
        kind=meta["kind"][i],
        chrom=meta["chrom"][i],
        pos=meta["pos"][i],
        ref_allele=meta["ref"][i],
        alt_allele=meta["alt"][i],
        svlen=meta["svlen"][i] or 0,
        precise=meta["precise"][i],
        cipos=tuple(meta["cipos"][i]) if meta["cipos"][i] else None,
        ciend=tuple(meta["ciend"][i]) if meta["ciend"][i] else None,
        haplotype=meta["haplotype"][i],
        heterozygosity=meta["het"][i],
        somatic_effective_mutation_rate=meta["som"][i],
    )
    v.aux_info = meta["aux"][i] or {}
    return v


class ObsColumns:
    """Flat per-obs wire columns for a run of records (single sample).

    f16 [N, N_CF] float16; u8 [N, N_CU] uint8; hil [N] int8;
    third [N] int16 (-1 = None); frag [N] int64 (-1 = None)."""

    __slots__ = ("f16", "u8", "hil", "third", "frag")

    def __init__(self, f16, u8, hil, third, frag):
        self.f16 = f16
        self.u8 = u8
        self.hil = hil
        self.third = third
        self.frag = frag

    @classmethod
    def empty(cls):
        from ..ops.compact_obs import N_CF, N_CU

        return cls(
            np.zeros((0, N_CF), np.float16),
            np.zeros((0, N_CU), np.uint8),
            np.zeros(0, np.int8),
            np.zeros(0, np.int16),
            np.zeros(0, np.int64),
        )

    @classmethod
    def concat(cls, parts):
        if not parts:
            return cls.empty()
        return cls(
            np.concatenate([p.f16 for p in parts]),
            np.concatenate([p.u8 for p in parts]),
            np.concatenate([p.hil for p in parts]),
            np.concatenate([p.third for p in parts]),
            np.concatenate([p.frag for p in parts]),
        )

    def slice(self, a, b):
        return ObsColumns(
            self.f16[a:b], self.u8[a:b], self.hil[a:b],
            self.third[a:b], self.frag[a:b],
        )

    @classmethod
    def from_observations(cls, observations):
        """Pack ReadObservation objects (the preprocess writer's input)."""
        from ..ops.compact_obs import (
            CF_PA, CF_PDO, CF_PHA, CF_PHB, CF_PHV, CF_PM, CF_PME, CF_PR,
            CF_PSA, CU_ALT_LOCUS, CU_FLAGS, CU_RO, CU_STRAND,
            FLAG_IS_MAX_MAPQ, FLAG_PAIRED, FLAG_READ_POSITION_MAJOR,
            FLAG_SOFTCLIPPED, N_CF, N_CU,
        )
        from ..evidence.observation import READ_POSITION_MAJOR

        N = len(observations)
        f16 = np.zeros((N, N_CF), dtype=np.float16)
        u8 = np.zeros((N, N_CU), dtype=np.uint8)
        hil = np.full(N, HOMOPOLYMER_NONE, dtype=np.int8)
        third = np.full(N, -1, dtype=np.int16)
        frag = np.full(N, -1, dtype=np.int64)
        for i, o in enumerate(observations):
            f16[i, CF_PM] = o.eff_prob_mapping()
            f16[i, CF_PA] = o.prob_alt
            f16[i, CF_PR] = o.prob_ref
            f16[i, CF_PME] = o.prob_missed_allele
            f16[i, CF_PSA] = o.prob_sample_alt
            f16[i, CF_PDO] = o.prob_double_overlap
            f16[i, CF_PHB] = o.prob_hit_base
            f16[i, CF_PHA] = (
                o.prob_observable_at_homopolymer_artifact
                if o.prob_observable_at_homopolymer_artifact is not None
                else np.nan
            )
            f16[i, CF_PHV] = (
                o.prob_observable_at_homopolymer_variant
                if o.prob_observable_at_homopolymer_variant is not None
                else np.nan
            )
            u8[i, CU_STRAND] = o.strand
            u8[i, CU_RO] = o.read_orientation
            u8[i, CU_FLAGS] = (
                (FLAG_SOFTCLIPPED if o.softclipped else 0)
                | (FLAG_PAIRED if o.paired else 0)
                | (
                    FLAG_READ_POSITION_MAJOR
                    if o.read_position == READ_POSITION_MAJOR
                    else 0
                )
                | (FLAG_IS_MAX_MAPQ if o.is_max_mapq else 0)
            )
            u8[i, CU_ALT_LOCUS] = o.alt_locus
            if o.homopolymer_indel_len is not None:
                hil[i] = max(-126, min(126, o.homopolymer_indel_len))
            if o.third_allele_evidence is not None:
                third[i] = min(o.third_allele_evidence, 32766)
            if o.fragment_id is not None:
                frag[i] = o.fragment_id
        return cls(f16, u8, hil, third, frag)

    def to_observation(self, i) -> ReadObservation:
        """Materialize one ReadObservation (compat iteration path)."""
        from ..ops.compact_obs import (
            CF_PA, CF_PDO, CF_PHA, CF_PHB, CF_PHV, CF_PM, CF_PME, CF_PR,
            CF_PSA, CU_ALT_LOCUS, CU_FLAGS, CU_RO, CU_STRAND,
            FLAG_IS_MAX_MAPQ, FLAG_PAIRED, FLAG_READ_POSITION_MAJOR,
            FLAG_SOFTCLIPPED,
        )
        from ..evidence.observation import (
            READ_POSITION_MAJOR,
            READ_POSITION_SOME,
            set_prob_mapping,
            set_prob_overlap,
        )

        o = ReadObservation()
        row = self.f16[i].astype(np.float64)
        set_prob_mapping(o, float(row[CF_PM]))
        o.prob_alt = float(row[CF_PA])
        o.prob_ref = float(row[CF_PR])
        o.prob_missed_allele = float(row[CF_PME])
        o.prob_sample_alt = float(row[CF_PSA])
        set_prob_overlap(o, float(row[CF_PDO]))
        o.prob_hit_base = float(row[CF_PHB])
        pha = float(row[CF_PHA])
        phv = float(row[CF_PHV])
        o.prob_observable_at_homopolymer_artifact = (
            None if math.isnan(pha) else pha
        )
        o.prob_observable_at_homopolymer_variant = (
            None if math.isnan(phv) else phv
        )
        o.strand = int(self.u8[i, CU_STRAND])
        o.read_orientation = int(self.u8[i, CU_RO])
        flags = int(self.u8[i, CU_FLAGS])
        o.softclipped = bool(flags & FLAG_SOFTCLIPPED)
        o.paired = bool(flags & FLAG_PAIRED)
        o.read_position = (
            READ_POSITION_MAJOR
            if flags & FLAG_READ_POSITION_MAJOR
            else READ_POSITION_SOME
        )
        o.is_max_mapq = bool(flags & FLAG_IS_MAX_MAPQ)
        o.alt_locus = int(self.u8[i, CU_ALT_LOCUS])
        h = int(self.hil[i])
        o.homopolymer_indel_len = None if h == HOMOPOLYMER_NONE else h
        t = int(self.third[i])
        o.third_allele_evidence = None if t < 0 else t
        f = int(self.frag[i])
        o.fragment_id = None if f < 0 else f
        return o


def _dicts_to_columns(obs_dicts) -> ObsColumns:
    """JSONL obs dicts -> wire columns without ReadObservation objects."""
    from ..ops.compact_obs import (
        CF_PA, CF_PDO, CF_PHA, CF_PHB, CF_PHV, CF_PM, CF_PME, CF_PR,
        CF_PSA, CU_ALT_LOCUS, CU_FLAGS, CU_RO, CU_STRAND,
        FLAG_IS_MAX_MAPQ, FLAG_PAIRED, FLAG_READ_POSITION_MAJOR,
        FLAG_SOFTCLIPPED, N_CF, N_CU,
    )
    from ..evidence.observation import READ_POSITION_MAJOR

    N = len(obs_dicts)
    f16 = np.zeros((N, N_CF), dtype=np.float16)
    u8 = np.zeros((N, N_CU), dtype=np.uint8)
    hil = np.full(N, HOMOPOLYMER_NONE, dtype=np.int8)
    third = np.full(N, -1, dtype=np.int16)
    frag = np.full(N, -1, dtype=np.int64)

    def fval(x):
        if x is None:
            return np.nan
        if x == "-inf":
            return -np.inf
        return x

    for i, d in enumerate(obs_dicts):
        f16[i, CF_PM] = fval(d["pm"])
        f16[i, CF_PA] = fval(d["pa"])
        f16[i, CF_PR] = fval(d["pr"])
        f16[i, CF_PME] = fval(d["pme"])
        f16[i, CF_PSA] = fval(d["psa"])
        f16[i, CF_PDO] = fval(d["pdo"])
        f16[i, CF_PHB] = fval(d["phb"])
        f16[i, CF_PHA] = fval(d["pha"])
        f16[i, CF_PHV] = fval(d["phv"])
        u8[i, CU_STRAND] = d["st"]
        u8[i, CU_RO] = d["ro"]
        u8[i, CU_FLAGS] = (
            (FLAG_SOFTCLIPPED if d["sc"] else 0)
            | (FLAG_PAIRED if d["pd"] else 0)
            | (
                FLAG_READ_POSITION_MAJOR
                if d["rp"] == READ_POSITION_MAJOR
                else 0
            )
            | (FLAG_IS_MAX_MAPQ if d["mm"] else 0)
        )
        u8[i, CU_ALT_LOCUS] = d["al"]
        if d["hil"] is not None:
            hil[i] = max(-126, min(126, d["hil"]))
        if d["ta"] is not None:
            third[i] = min(d["ta"], 32766)
        f = d.get("f")
        if f is not None:
            frag[i] = f
    return ObsColumns(f16, u8, hil, third, frag)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


class ObservationWriter:
    """Observation file writer.  format: "binary" (vlt-tpu-2, default) or
    "jsonl" (vlt-tpu-1); VLT_OBS_FORMAT overrides the default."""

    def __init__(self, path, sample_name: str, options: dict | None = None,
                 format: str | None = None):
        self.path = path
        fmt = format or os.environ.get("VLT_OBS_FORMAT", "binary")
        self._binary = fmt != "jsonl"
        header = {
            "format_version": (
                OBSERVATION_FORMAT_VERSION_V2
                if self._binary
                else OBSERVATION_FORMAT_VERSION
            ),
            "sample": sample_name,
            "options": options or {},
        }
        if self._binary:
            self._fh = open(path, "wb")
            hdr = json.dumps(header).encode()
            self._fh.write(MAGIC_V2)
            self._fh.write(struct.pack("<I", len(hdr)))
            self._fh.write(hdr)
            self._meta = {k: [] for k in _META_KEYS}
            self._parts = []
        else:
            self._fh = (
                gzip.open(path, "wt")
                if str(path).endswith(".gz")
                else open(path, "wt")
            )
            print(json.dumps(header), file=self._fh)

    def write_record(self, variant: VariantInfo, pileup: Pileup,
                     aux: dict | None = None):
        if self._binary:
            _variant_to_meta(variant, pileup, aux, self._meta)
            self._parts.append(
                ObsColumns.from_observations(pileup.read_observations)
            )
            if len(self._meta["pos"]) >= CHUNK_RECORDS:
                self._flush_chunk()
            return
        rec = {
            "chrom": variant.chrom,
            "pos": variant.pos,
            "kind": variant.kind,
            "ref": variant.ref_allele,
            "alt": variant.alt_allele,
            "svlen": variant.svlen,
            "precise": variant.precise,
            "haplotype": variant.haplotype,
            "het": variant.heterozygosity,
            "som": variant.somatic_effective_mutation_rate,
            "obs": [obs_to_dict(o) for o in pileup.read_observations],
        }
        if variant.cipos is not None:
            rec["cipos"] = list(variant.cipos)
        if variant.ciend is not None:
            rec["ciend"] = list(variant.ciend)
        if pileup.raw_depth is not None:
            # depth observation (reference placeholder depth_observation.rs)
            rec["dp"] = pileup.raw_depth
        if aux:
            # --propagate-info-fields passthrough (utils/aux_info.rs:52-135)
            rec["aux"] = aux
        print(json.dumps(rec), file=self._fh)

    def write_window(self, variants, counts, cols, dp):
        """Append a columnar window (observations.read_window layout)
        without materializing per-read objects — the shard-merge fast path
        (binary format only)."""
        assert self._binary
        off = 0
        for i, v in enumerate(variants):
            c = int(counts[i])
            self._meta["chrom"].append(v.chrom)
            self._meta["pos"].append(v.pos)
            self._meta["kind"].append(v.kind)
            self._meta["ref"].append(v.ref_allele)
            self._meta["alt"].append(v.alt_allele)
            self._meta["svlen"].append(v.svlen)
            self._meta["precise"].append(bool(v.precise))
            self._meta["haplotype"].append(v.haplotype)
            self._meta["het"].append(v.heterozygosity)
            self._meta["som"].append(v.somatic_effective_mutation_rate)
            self._meta["cipos"].append(list(v.cipos) if v.cipos else None)
            self._meta["ciend"].append(list(v.ciend) if v.ciend else None)
            self._meta["dp"].append(None if dp[i] < 0 else int(dp[i]))
            self._meta["aux"].append(getattr(v, "aux_info", None) or None)
            self._meta["counts"].append(c)
            off += c
        self._parts.append(cols)
        if len(self._meta["pos"]) >= CHUNK_RECORDS:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._meta["pos"]:
            return
        cols = ObsColumns.concat(self._parts)
        meta_z = zlib.compress(json.dumps(self._meta).encode(), 1)
        payload = b"".join(
            [
                cols.f16.tobytes(),
                cols.u8.tobytes(),
                cols.hil.tobytes(),
                cols.third.tobytes(),
                cols.frag.astype(np.int32).tobytes(),
            ]
        )
        payload_z = zlib.compress(payload, 1)
        self._fh.write(
            struct.pack(
                "<III",
                len(meta_z),
                cols.f16.shape[0],
                len(payload_z),
            )
        )
        self._fh.write(meta_z)
        self._fh.write(payload_z)
        self._meta = {k: [] for k in _META_KEYS}
        self._parts = []

    def close(self):
        if self._binary:
            self._flush_chunk()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


class ObservationReader:
    """Auto-detecting observation file reader (vlt-tpu-1 JSONL or vlt-tpu-2
    binary).  Iteration yields (VariantInfo, Pileup); ``read_window(n)``
    yields columnar (variants, counts, ObsColumns, raw_depth) batches cut at
    contig boundaries."""

    def __init__(self, path):
        self.path = path
        raw = open(path, "rb")
        magic = raw.read(len(MAGIC_V2))
        if magic == MAGIC_V2:
            self._binary = True
            self._fh = raw
            (hlen,) = struct.unpack("<I", raw.read(4))
            self.header = json.loads(raw.read(hlen))
            if (
                self.header.get("format_version")
                != OBSERVATION_FORMAT_VERSION_V2
            ):
                raise ValueError(
                    f"observation format version mismatch in {path}"
                )
            # leftover from a contig-boundary / window split
            self._pending = None  # (variants, counts, ObsColumns, dp)
            return
        raw.close()
        self._binary = False
        self._fh = (
            gzip.open(path, "rt")
            if str(path).endswith(".gz")
            else open(path, "rt")
        )
        self.header = json.loads(self._fh.readline())
        if self.header.get("format_version") != OBSERVATION_FORMAT_VERSION:
            raise ValueError(
                f"observation format version mismatch in {path}: "
                f"{self.header.get('format_version')} != {OBSERVATION_FORMAT_VERSION}; "
                "please rerun preprocess"
            )
        self._pending = None

    @property
    def sample_name(self):
        return self.header["sample"]

    # ---- chunk-level decode (binary) ----
    def _read_chunk(self):
        hdr = self._fh.read(12)
        if len(hdr) < 12:
            return None
        meta_len, n_obs, payload_len = struct.unpack("<III", hdr)
        meta = json.loads(zlib.decompress(self._fh.read(meta_len)))
        payload = zlib.decompress(self._fh.read(payload_len))
        from ..ops.compact_obs import N_CF, N_CU

        off = 0

        def take(dtype, shape):
            nonlocal off
            a = np.frombuffer(
                payload, dtype=dtype, count=int(np.prod(shape)), offset=off
            ).reshape(shape)
            off += a.nbytes
            return a

        f16 = take(np.float16, (n_obs, N_CF))
        u8 = take(np.uint8, (n_obs, N_CU))
        hil = take(np.int8, (n_obs,))
        third = take(np.int16, (n_obs,))
        frag = take(np.int32, (n_obs,)).astype(np.int64)
        variants = [_meta_to_variant(meta, i) for i in range(len(meta["pos"]))]
        counts = np.asarray(meta["counts"], dtype=np.int64)
        dp = np.asarray(
            [(-1 if d is None else d) for d in meta["dp"]], dtype=np.int64
        )
        return variants, counts, ObsColumns(f16, u8, hil, third, frag), dp

    def _read_jsonl_window(self, n):
        """Parse up to n JSONL records into a columnar block."""
        variants, counts, dps, obs_dicts = [], [], [], []
        for line in self._fh:
            d = json.loads(line)
            variants.append(
                VariantInfo(
                    kind=d["kind"],
                    chrom=d["chrom"],
                    pos=d["pos"],
                    ref_allele=d["ref"],
                    alt_allele=d["alt"],
                    svlen=d.get("svlen", 0),
                    precise=d.get("precise", True),
                    cipos=tuple(d["cipos"]) if d.get("cipos") else None,
                    ciend=tuple(d["ciend"]) if d.get("ciend") else None,
                    haplotype=d.get("haplotype"),
                    heterozygosity=d.get("het"),
                    somatic_effective_mutation_rate=d.get("som"),
                )
            )
            variants[-1].aux_info = d.get("aux") or {}
            counts.append(len(d["obs"]))
            dps.append(-1 if d.get("dp") is None else d["dp"])
            obs_dicts.extend(d["obs"])
            if len(variants) >= n:
                break
        if not variants:
            return None
        return (
            variants,
            np.asarray(counts, dtype=np.int64),
            _dicts_to_columns(obs_dicts),
            np.asarray(dps, dtype=np.int64),
        )

    # ---- public columnar window API ----
    def read_window(self, n):
        """Up to n records of ONE contig as (variants, counts [L],
        ObsColumns, raw_depth [L]); None at EOF."""
        acc = self._pending
        self._pending = None
        parts = [acc] if acc else []
        total = len(acc[0]) if acc else 0
        while total < n:
            nxt = (
                self._read_chunk()
                if self._binary
                else self._read_jsonl_window(n - total)
            )
            if nxt is None:
                break
            parts.append(nxt)
            total += len(nxt[0])
        if not parts:
            return None
        variants = [v for p in parts for v in p[0]]
        counts = np.concatenate([p[1] for p in parts])
        cols = ObsColumns.concat([p[2] for p in parts])
        dp = np.concatenate([p[3] for p in parts])
        # cut at window size or first contig change, stash the tail
        cut = len(variants)
        first = variants[0].chrom
        for i, v in enumerate(variants):
            if i >= n or v.chrom != first:
                cut = i
                break
        if cut < len(variants):
            obs_cut = int(counts[:cut].sum())
            self._pending = (
                variants[cut:],
                counts[cut:],
                cols.slice(obs_cut, len(cols.hil)),
                dp[cut:],
            )
            variants = variants[:cut]
            counts = counts[:cut]
            cols = cols.slice(0, obs_cut)
            dp = dp[:cut]
        return variants, counts, cols, dp

    # ---- compat object iteration ----
    def __iter__(self):
        while True:
            w = self.read_window(CHUNK_RECORDS)
            if w is None:
                return
            variants, counts, cols, dp = w
            off = 0
            for i, v in enumerate(variants):
                c = int(counts[i])
                obs = [cols.to_observation(off + j) for j in range(c)]
                off += c
                yield v, Pileup(
                    read_observations=obs,
                    raw_depth=None if dp[i] < 0 else int(dp[i]),
                )

    def close(self):
        self._fh.close()
