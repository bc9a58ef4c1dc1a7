"""BCF 2.x reader (uncompressed or BGZF), yielding VcfRecord objects.

Covers the candidate/call I/O parity with the reference's rust-htslib BCF
usage for reading.  Site-level fields (CHROM/POS/ID/REF/ALT/FILTER/INFO) are
decoded; per-sample FORMAT blocks are skipped (candidates only need sites).
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np

from .bam import _decode_bgzf
from .vcf import VcfRecord

_MISSING_INT8 = -128
_MISSING_INT16 = -32768
_MISSING_INT32 = -2147483648


class BcfReader:
    def __init__(self, path):
        from ..errors import MalformedBcfError

        self.path = Path(path)
        raw = self.path.read_bytes()
        try:
            if raw[:2] == b"\x1f\x8b":
                raw = _decode_bgzf(raw)
        except Exception as e:  # noqa: BLE001 - zlib/struct internals
            raise MalformedBcfError(f"BGZF stream of {path}: {e}") from e
        if raw[:3] != b"BCF":
            raise MalformedBcfError(f"{path} lacks the BCF magic")
        try:
            # magic BCF\major\minor
            l_text = struct.unpack_from("<I", raw, 5)[0]
            self.header_text = raw[9 : 9 + l_text].rstrip(b"\x00").decode("latin1")
            self._pos = 9 + l_text
            self._raw = raw
            self._parse_header()
        except MalformedBcfError:
            raise
        except Exception as e:  # noqa: BLE001
            raise MalformedBcfError(f"header of {path}: {e}") from e

    def _parse_header(self):
        self.header_lines = [
            l for l in self.header_text.split("\n") if l.startswith("##")
        ]
        self.sample_names = []
        for line in self.header_text.split("\n"):
            if line.startswith("#CHROM"):
                cols = line.split("\t")
                self.sample_names = cols[9:]
        # contig dictionary
        self.contigs = []
        contig_idx = {}
        # string dictionary (FILTER/INFO/FORMAT ids)
        strings = {}
        order = 0
        if not any(
            re.match(r"##FILTER=<ID=PASS", l) for l in self.header_lines
        ):
            strings[0] = "PASS"
            order = 1
        seen = {"PASS"} if 0 in strings else set()
        for line in self.header_lines:
            m = re.match(r"##contig=<([^>]*)>", line)
            if m:
                name = None
                idx = None
                for kv in re.findall(r"(\w+)=([^,>]+)", m.group(1)):
                    if kv[0] == "ID":
                        name = kv[1]
                    elif kv[0] == "IDX":
                        idx = int(kv[1])
                if name is not None:
                    if idx is None:
                        idx = len(contig_idx)
                    contig_idx[idx] = name
                continue
            m = re.match(r"##(FILTER|INFO|FORMAT)=<(.*)>", line)
            if m:
                name = None
                idx = None
                for kv in re.findall(r"(\w+)=([^,>\"]+|\"[^\"]*\")", m.group(2)):
                    if kv[0] == "ID":
                        name = kv[1]
                    elif kv[0] == "IDX":
                        idx = int(kv[1])
                if name is None or name in seen:
                    continue
                seen.add(name)
                if idx is None:
                    idx = order
                strings[idx] = name
                order = max(order, idx) + 1
        self._strings = strings
        self._contigs = contig_idx

    # ------------------------------------------------------------------
    def _typed(self, pos):
        """Decode one typed value; returns (value, new_pos)."""
        desc = self._raw[pos]
        pos += 1
        typ = desc & 0x0F
        count = desc >> 4
        if count == 15:
            count, pos = self._typed(pos)
            count = int(count[0]) if isinstance(count, (list, np.ndarray)) else int(count)
        if typ == 0:
            return [], pos
        if typ == 1:
            vals = np.frombuffer(self._raw, np.int8, count, pos)
            return vals, pos + count
        if typ == 2:
            vals = np.frombuffer(self._raw, "<i2", count, pos)
            return vals, pos + 2 * count
        if typ == 3:
            vals = np.frombuffer(self._raw, "<i4", count, pos)
            return vals, pos + 4 * count
        if typ == 5:
            vals = np.frombuffer(self._raw, "<f4", count, pos)
            return vals, pos + 4 * count
        if typ == 7:
            s = self._raw[pos : pos + count].decode("latin1")
            return s, pos + count
        raise ValueError(f"bad BCF type {typ}")

    def __iter__(self):
        from ..errors import MalformedBcfError

        try:
            yield from self._iter_records()
        except MalformedBcfError:
            raise
        except Exception as e:  # noqa: BLE001 - struct/index internals
            raise MalformedBcfError(f"record block in {self.path}: {e}") from e

    def _iter_records(self):
        pos = self._pos
        raw = self._raw
        n = len(raw)
        while pos + 8 <= n:
            l_shared, l_indiv = struct.unpack_from("<II", raw, pos)
            if l_shared < 24 or pos + 8 + l_shared + l_indiv > n:
                from ..errors import MalformedBcfError

                raise MalformedBcfError(
                    f"record lengths ({l_shared}, {l_indiv}) at offset {pos} "
                    "exceed the decompressed stream"
                )
            rec_start = pos + 8
            p = rec_start
            chrom_id, rpos, _rlen = struct.unpack_from("<iii", raw, p)
            qual = struct.unpack_from("<f", raw, p + 12)[0]
            n_info_allele = struct.unpack_from("<I", raw, p + 16)[0]
            n_info = n_info_allele & 0xFFFF
            n_allele = n_info_allele >> 16
            n_fmt_sample = struct.unpack_from("<I", raw, p + 20)[0]
            n_sample = n_fmt_sample & 0xFFFFFF
            n_fmt = n_fmt_sample >> 24
            p += 24
            vid, p = self._typed(p)
            alleles = []
            for _ in range(n_allele):
                a, p = self._typed(p)
                alleles.append(a if isinstance(a, str) else "")
            filters, p = self._typed(p)
            info = {}
            for _ in range(n_info):
                key_idx, p = self._typed(p)
                key_idx = int(np.asarray(key_idx).ravel()[0])
                val, p = self._typed(p)
                name = self._strings.get(key_idx, f"KEY{key_idx}")
                if isinstance(val, str):
                    info[name] = val
                elif len(val) == 0:
                    info[name] = True  # flag
                elif len(val) == 1:
                    v = val[0]
                    info[name] = (
                        float(v) if val.dtype.kind == "f" else int(v)
                    )
                else:
                    info[name] = [
                        float(v) if val.dtype.kind == "f" else int(v) for v in val
                    ]
            # FORMAT/sample block: per field a typed key then a typed
            # descriptor whose count is PER SAMPLE, repeated n_sample times
            fmt_keys = []
            samples = [dict() for _ in range(n_sample)]
            p = rec_start + l_shared
            for _ in range(n_fmt):
                key_idx, p = self._typed(p)
                key_idx = int(np.asarray(key_idx).ravel()[0])
                name = self._strings.get(key_idx, f"KEY{key_idx}")
                fmt_keys.append(name)
                desc = raw[p]
                p += 1
                typ = desc & 0x0F
                count = desc >> 4
                if count == 15:
                    cv, p = self._typed(p)
                    count = int(np.asarray(cv).ravel()[0])
                for si in range(n_sample):
                    if typ == 0:
                        samples[si][name] = "."
                        continue
                    if typ == 7:
                        s = raw[p : p + count].decode("latin1").rstrip("\x00")
                        p += count
                        samples[si][name] = s if s else "."
                        continue
                    if typ == 1:
                        vals = np.frombuffer(raw, np.int8, count, p)
                        p += count
                        miss = -128
                    elif typ == 2:
                        vals = np.frombuffer(raw, "<i2", count, p)
                        p += 2 * count
                        miss = -32768
                    elif typ == 3:
                        vals = np.frombuffer(raw, "<i4", count, p)
                        p += 4 * count
                        miss = -2147483648
                    elif typ == 5:
                        vals = np.frombuffer(raw, "<f4", count, p)
                        p += 4 * count
                        miss = None
                    else:
                        raise ValueError(f"bad BCF FORMAT type {typ}")
                    parts = []
                    for v in vals:
                        if miss is not None and v == miss:
                            parts.append(".")
                        elif miss is None and np.isnan(v):
                            parts.append(".")
                        else:
                            parts.append(
                                f"{float(v):g}" if miss is None else str(int(v))
                            )
                    samples[si][name] = ",".join(parts)
            pos = rec_start + l_shared + l_indiv
            yield VcfRecord(
                chrom=self._contigs.get(chrom_id, str(chrom_id)),
                pos=rpos,
                id=vid if isinstance(vid, str) and vid else ".",
                ref=alleles[0] if alleles else "N",
                alts=list(alleles[1:]),
                qual="." if np.isnan(qual) else f"{qual:g}",
                filter=".",
                info=info,
                format=fmt_keys,
                samples=samples,
            )

    def records(self):
        return list(self)


# ---------------------------------------------------------------------------
# BCF 2.2 writing (BGZF-compressed), mirroring the implicit-dictionary
# conventions of the reader above (PASS = 0, then FILTER/INFO/FORMAT header
# order). Typed encoding follows the BCF spec; value types come from the
# header's Type= declarations.
# ---------------------------------------------------------------------------


def _typed_desc(count: int, typ: int) -> bytes:
    if count < 15:
        return bytes([(count << 4) | typ])
    return bytes([(15 << 4) | typ]) + _typed_ints([count])


def _typed_ints(vals) -> bytes:
    vals = [int(v) for v in vals]
    lo = min(vals) if vals else 0
    hi = max(vals) if vals else 0
    if -120 <= lo and hi <= 127:
        return _typed_desc(len(vals), 1) + struct.pack(f"<{len(vals)}b", *vals)
    if -32000 <= lo and hi <= 32767:
        return _typed_desc(len(vals), 2) + struct.pack(f"<{len(vals)}h", *vals)
    return _typed_desc(len(vals), 3) + struct.pack(f"<{len(vals)}i", *vals)


def _typed_floats(vals) -> bytes:
    return _typed_desc(len(vals), 5) + struct.pack(f"<{len(vals)}f", *vals)


def _typed_str(s: str) -> bytes:
    b = s.encode("latin1")
    return _typed_desc(len(b), 7) + b


_MISSING = b"\x00"  # type 0, count 0


class BcfWriter:
    """Write VcfRecord streams as BGZF-compressed BCF 2.2."""

    def __init__(self, path, sample_names=None, header_lines=None):
        self.path = Path(path)
        self.sample_names = list(sample_names or [])
        lines = [l for l in (header_lines or []) if l.startswith("##")]
        if not any(l.startswith("##fileformat") for l in lines):
            lines.insert(0, "##fileformat=VCFv4.2")
        chrom_cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if self.sample_names:
            chrom_cols += ["FORMAT"] + self.sample_names
        self._lines = lines
        self._chrom_line = "\t".join(chrom_cols)
        self._declared_contigs = None  # filled below
        self._declared_strings = None
        # dictionaries (same implicit order as BcfReader._parse_header);
        # explicit IDX= attributes (written by htslib for non-contiguous
        # dictionaries) OVERRIDE appearance order — conformant readers
        # honor them, so ignoring them would silently mis-key INFO/contig
        # data when header lines are passed through from an htslib BCF
        self._string_idx = {}
        self._contig_idx = {}
        if not any(re.match(r"##FILTER=<ID=PASS", l) for l in lines):
            self._string_idx["PASS"] = 0

        def _explicit_idx(line):
            m = re.search(r"[<,]IDX=(\d+)", line)
            return int(m.group(1)) if m else None

        for line in lines:
            m = re.match(r"##contig=<[^>]*?ID=([^,>]+)", line)
            if m:
                idx = _explicit_idx(line)
                if idx is not None:
                    self._contig_idx[m.group(1)] = idx
                else:
                    self._contig_idx.setdefault(
                        m.group(1), len(self._contig_idx)
                    )
                continue
            m = re.match(r"##(?:FILTER|INFO|FORMAT)=<[^>]*?ID=(\w+)", line)
            if m:
                idx = _explicit_idx(line)
                if idx is not None:
                    self._string_idx[m.group(1)] = idx
                elif m.group(1) not in self._string_idx:
                    nxt = 0
                    used = set(self._string_idx.values())
                    while nxt in used:
                        nxt += 1
                    self._string_idx[m.group(1)] = nxt
        # field value types from header declarations
        self._types = {}
        for line in lines:
            m = re.match(r"##(?:INFO|FORMAT)=<[^>]*?ID=(\w+)[^>]*?Type=(\w+)", line)
            if m:
                self._types[m.group(1)] = m.group(2)
        self._body = bytearray()
        self._declared_contigs = set(self._contig_idx)
        self._declared_strings = set(self._string_idx)

    # -- encoding ------------------------------------------------------
    def _encode_value(self, name: str, val) -> bytes:
        typ = self._types.get(name, "String")
        if val is True:
            return _MISSING
        if isinstance(val, (list, tuple, np.ndarray)):
            vals = list(val)
        else:
            vals = str(val).split(",") if isinstance(val, str) and typ != "String" else [val]
        if typ == "Integer":
            try:
                return _typed_ints([int(float(v)) for v in vals])
            except (ValueError, OverflowError):
                return _typed_str(",".join(str(v) for v in vals))
        if typ == "Float":
            out = []
            for v in vals:
                try:
                    out.append(float(v))
                except ValueError:
                    out.append(float("inf") if str(v) == "inf" else float("nan"))
            return _typed_floats(out)
        return _typed_str(",".join(str(v) for v in vals))

    def write(self, rec):
        info = rec.info or {}
        shared = bytearray()
        rid = self._contig_idx.setdefault(rec.chrom, len(self._contig_idx))
        qual = float("nan") if rec.qual in (".", None, "") else float(rec.qual)
        n_allele = 1 + len(rec.alts)
        fmt_keys = [k for k in (rec.format or []) if k in self._string_idx]
        shared += struct.pack(
            "<iiif", rid, rec.pos, len(rec.ref), qual
        )
        shared += struct.pack("<I", (n_allele << 16) | (len(info) & 0xFFFF))
        shared += struct.pack(
            "<I", (len(fmt_keys) << 24) | (len(self.sample_names) & 0xFFFFFF)
        )
        shared += _typed_str(rec.id) if rec.id and rec.id != "." else _MISSING
        shared += _typed_str(rec.ref)
        for a in rec.alts:
            shared += _typed_str(a)
        shared += _MISSING  # FILTER: missing
        for k, v in info.items():
            idx = self._string_idx.setdefault(k, len(self._string_idx))
            shared += _typed_ints([idx])
            shared += self._encode_value(k, v)

        indiv = bytearray()
        for k in fmt_keys:
            indiv += _typed_ints([self._string_idx[k]])
            vals = [str((s or {}).get(k, ".")) for s in (rec.samples or [])]
            typ = self._types.get(k, "String")
            if typ in ("Integer", "Float") and all("," not in v for v in vals):
                try:
                    if typ == "Integer":
                        ints = [
                            int(float(v)) if v != "." else None for v in vals
                        ]
                        # pick the narrowest BCF int width that fits every
                        # value OUTSIDE the reserved missing/EOV range
                        # (int16 alone crashed on DP > 32767 deep pileups)
                        fin = [x for x in ints if x is not None]
                        lo = min(fin, default=0)
                        hi = max(fin, default=0)
                        if -120 <= lo and hi <= 127:
                            t, fmtc, miss = 1, "<b", -128
                        elif -32000 <= lo and hi <= 32767:
                            t, fmtc, miss = 2, "<h", -32768
                        else:
                            t, fmtc, miss = 3, "<i", -2147483648
                        enc = _typed_desc(1, t) + b"".join(
                            struct.pack(fmtc, x if x is not None else miss)
                            for x in ints
                        )
                    else:
                        enc = _typed_desc(1, 5) + b"".join(
                            struct.pack(
                                "<f", float(v) if v != "." else float("nan")
                            )
                            for v in vals
                        )
                    indiv += enc
                    continue
                except (ValueError, struct.error):
                    pass  # fall back to string encoding
            width = max((len(v) for v in vals), default=1)
            indiv += _typed_desc(width, 7) + b"".join(
                v.encode("latin1").ljust(width, b"\x00") for v in vals
            )

        self._body += struct.pack("<II", len(shared), len(indiv))
        self._body += shared + indiv

    @property
    def header_text(self) -> str:
        """Header with dictionary entries discovered while writing records
        (contigs / INFO keys first seen in a record must appear in the
        header, in index order, or readers resolve them to bare indices)."""
        extra = []
        for name, _ in sorted(self._contig_idx.items(), key=lambda kv: kv[1]):
            if name not in self._declared_contigs:
                extra.append(f"##contig=<ID={name}>")
        for name, _ in sorted(self._string_idx.items(), key=lambda kv: kv[1]):
            if name not in self._declared_strings and name != "PASS":
                extra.append(
                    f'##INFO=<ID={name},Number=.,Type=String,Description="">'
                )
        return "\n".join(self._lines + extra + [self._chrom_line]) + "\n"

    def close(self):
        from .bam import _encode_bgzf

        text = self.header_text.encode("latin1") + b"\x00"
        head = b"BCF\x02\x02" + struct.pack("<I", len(text)) + text
        self.path.write_bytes(_encode_bgzf(bytes(head + self._body)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
