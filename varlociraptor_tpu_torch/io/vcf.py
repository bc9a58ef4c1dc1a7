"""VCF text reader/writer.

Host-side candidate/call I/O replacing the reference's rust-htslib BCF usage
(``src/utils/collect_variants.rs``,
``src/calling/variants/mod.rs:178-576``).  Plain (optionally
gzip/BGZF-compressed) VCF text; BCF binary support can be layered on later —
the pipeline's intermediate observation format is our own (see
``calling.observations``), so VCF text covers candidates and final calls.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 0-based internally (VCF text is 1-based)
    id: str
    ref: str
    alts: list[str]
    qual: str = "."
    filter: str = "."
    info: dict = field(default_factory=dict)
    format: list[str] = field(default_factory=list)
    samples: list[dict] = field(default_factory=list)

    def info_get(self, key, default=None):
        return self.info.get(key, default)


def _parse_info(s: str) -> dict:
    info = {}
    if s == ".":
        return info
    for item in s.split(";"):
        if not item:
            continue
        if "=" in item:
            k, v = item.split("=", 1)
            info[k] = v
        else:
            info[item] = True
    return info


def _format_info(info: dict) -> str:
    if not info:
        return "."
    parts = []
    for k, v in info.items():
        if v is True:
            parts.append(k)
        elif isinstance(v, (list, tuple)):
            parts.append(f"{k}={','.join(str(x) for x in v)}")
        else:
            parts.append(f"{k}={v}")
    return ";".join(parts)


def open_variant_file(path):
    """Auto-detect VCF text / gzipped VCF / BCF (plain or BGZF)."""
    import gzip as _gzip

    with open(path, "rb") as f:
        head = f.read(4)
    if head[:3] == b"BCF":
        from .bcf import BcfReader

        return BcfReader(path)
    if head[:2] == b"\x1f\x8b":
        with _gzip.open(path, "rb") as f:
            inner = f.read(4)
        if inner[:3] == b"BCF":
            from .bcf import BcfReader

            return BcfReader(path)
    return VcfReader(path)


class VcfReader:
    def __init__(self, path):
        self.path = Path(path)
        self.header_lines: list[str] = []
        self.sample_names: list[str] = []
        self._records: list[VcfRecord] | None = None
        # parse the header eagerly so header_lines/sample_names are valid
        # immediately (accessing them before records() used to silently
        # return [] — a recurring footgun)
        with self._open() as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith("##"):
                    self.header_lines.append(line)
                elif line.startswith("#CHROM"):
                    self.sample_names = line.split("\t")[9:]
                    break
                else:
                    break

    def _open(self):
        raw = open(self.path, "rb").read(2)
        if raw == b"\x1f\x8b":
            return gzip.open(self.path, "rt")
        return open(self.path, "rt")

    def __iter__(self):
        # rebuild (not append) per pass so a second iteration does not
        # duplicate every header line in self.header_lines
        header: list[str] = []
        self.header_lines = header
        with self._open() as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith("##"):
                    header.append(line)
                    continue
                if line.startswith("#CHROM"):
                    cols = line.split("\t")
                    self.sample_names = cols[9:]
                    continue
                yield self._parse_line(line)

    def records(self) -> list[VcfRecord]:
        if self._records is None:
            self._records = list(self)
        return self._records

    @staticmethod
    def _parse_line(line: str) -> VcfRecord:
        cols = line.split("\t")
        if len(cols) < 5:
            from ..errors import MalformedVcfError

            raise MalformedVcfError(
                f"record line has {len(cols)} columns (expected >= 5): "
                f"{line[:80]!r}"
            )
        chrom, pos, vid, ref, alt = cols[0], cols[1], cols[2], cols[3], cols[4]
        qual = cols[5] if len(cols) > 5 else "."
        filt = cols[6] if len(cols) > 6 else "."
        info = _parse_info(cols[7]) if len(cols) > 7 else {}
        fmt = cols[8].split(":") if len(cols) > 8 else []
        samples = []
        for s in cols[9:]:
            vals = s.split(":")
            samples.append(dict(zip(fmt, vals)))
        try:
            pos0 = int(pos) - 1
        except ValueError as e:
            from ..errors import MalformedVcfError

            raise MalformedVcfError(f"non-numeric POS {pos!r} on {chrom}") from e
        return VcfRecord(
            chrom=chrom,
            pos=pos0,
            id=vid,
            ref=ref,
            alts=[] if alt == "." else alt.split(","),
            qual=qual,
            filter=filt,
            info=info,
            format=fmt,
            samples=samples,
        )


class VcfWriter:
    def __init__(self, path, sample_names=None, header_lines=None, fileformat="VCFv4.2"):
        self.path = Path(path) if path is not None else None
        self.sample_names = sample_names or []
        self.header_lines = [f"##fileformat={fileformat}"] + list(header_lines or [])
        self._fh = None

    def __enter__(self):
        import sys

        self._fh = open(self.path, "wt") if self.path else sys.stdout
        for line in self.header_lines:
            print(line, file=self._fh)
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if self.sample_names:
            cols += ["FORMAT"] + self.sample_names
        print("\t".join(cols), file=self._fh)
        return self

    def __exit__(self, *exc):
        if self.path and self._fh:
            self._fh.close()
        self._fh = None
        return False

    def write(self, rec: VcfRecord):
        cols = [
            rec.chrom,
            str(rec.pos + 1),
            rec.id or ".",
            rec.ref,
            ",".join(rec.alts) if rec.alts else ".",
            rec.qual,
            rec.filter,
            _format_info(rec.info),
        ]
        if self.sample_names:
            fmt = rec.format or ["."]
            cols.append(":".join(fmt))
            for s in rec.samples:
                cols.append(":".join(str(s.get(k, ".")) for k in fmt))
        print("\t".join(cols), file=self._fh)


def open_variant_writer(path, sample_names=None, header_lines=None):
    """VcfWriter for text output, BcfWriter when the path ends in .bcf."""
    if path is not None and str(path).endswith(".bcf"):
        from .bcf import BcfWriter

        return BcfWriter(path, sample_names=sample_names, header_lines=header_lines)
    return VcfWriter(path, sample_names=sample_names, header_lines=header_lines)
