"""BAI/CSI index parsing + virtual-offset chunk queries.

Genome-scale substrate for indexed region access
(``src/variants/sample.rs:96-139`` fetches through htslib's
index machinery): the binning scheme maps a [start, end) query to candidate
chunks of BGZF virtual offsets (coffset << 16 | uoffset), so a multi-GB BAM
is touched only where the pileup needs it.

BAI: fixed min_shift=14, depth=5, plain (uncompressed) file, linear index
per 16kb window.  CSI: BGZF-compressed, explicit min_shift/depth, per-bin
loffset replaces the linear index.  (SAM spec §5.2/§5.4.)
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path


def reg2bins(beg: int, end: int, min_shift: int, depth: int):
    """All bins overlapping [beg, end) (SAM spec reg2bins)."""
    if end <= beg:
        end = beg + 1
    bins = []
    t = 0
    s = min_shift + depth * 3
    for level in range(depth + 1):
        b = t + (beg >> s)
        e = t + ((end - 1) >> s)
        bins.extend(range(b, e + 1))
        s -= 3
        t += 1 << (level * 3)
    return bins


class BamIndex:
    """Parsed BAI or CSI index."""

    def __init__(self, min_shift, depth, bins_per_ref, ioffsets_per_ref,
                 mapped_per_ref=None):
        self.min_shift = min_shift
        self.depth = depth
        # per ref: {bin: (loffset, [(vbeg, vend), ...])}
        self.bins = bins_per_ref
        # per ref: linear index (BAI only; [] for CSI)
        self.ioffsets = ioffsets_per_ref
        # per ref: mapped record count from the metadata pseudo-bin
        # (None when the index carries no metadata)
        self.mapped_per_ref = mapped_per_ref

    def mapped_total(self):
        """Total mapped records per the index metadata (htslib
        index_stats equivalent); None if unavailable."""
        if not self.mapped_per_ref or all(
            m is None for m in self.mapped_per_ref
        ):
            return None
        return sum(m or 0 for m in self.mapped_per_ref)

    # -- loading -------------------------------------------------------
    @classmethod
    def load(cls, bam_path) -> "BamIndex | None":
        bam_path = Path(bam_path)
        for suffix, parse in ((".csi", cls._parse_csi), (".bai", cls._parse_bai)):
            for cand in (
                bam_path.with_suffix(bam_path.suffix + suffix),
                bam_path.with_suffix(suffix),
            ):
                if cand.exists():
                    return parse(cand.read_bytes())
        return None

    @classmethod
    def _parse_bai(cls, raw: bytes) -> "BamIndex":
        if raw[:4] != b"BAI\x01":
            raise ValueError("bad BAI magic")
        pos = 4
        (n_ref,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        bins_per_ref = []
        ioffsets_per_ref = []
        mapped_per_ref = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            bins = {}
            mapped = None
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", raw, pos)
                pos += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", raw, pos)
                    pos += 16
                    chunks.append((beg, end))
                if b != 37450:  # metadata pseudo-bin
                    bins[b] = (0, chunks)
                elif len(chunks) == 2:
                    # pseudo-bin chunk 2 = (n_mapped, n_unmapped)
                    mapped = chunks[1][0]
            (n_intv,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            ioff = list(struct.unpack_from(f"<{n_intv}Q", raw, pos))
            pos += 8 * n_intv
            bins_per_ref.append(bins)
            ioffsets_per_ref.append(ioff)
            mapped_per_ref.append(mapped)
        return cls(14, 5, bins_per_ref, ioffsets_per_ref, mapped_per_ref)

    @classmethod
    def _parse_csi(cls, raw: bytes) -> "BamIndex":
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        if raw[:4] != b"CSI\x01":
            raise ValueError("bad CSI magic")
        min_shift, depth, l_aux = struct.unpack_from("<iii", raw, 4)
        pos = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        # metadata pseudo-bin id for CSI
        max_bin = ((1 << ((depth + 1) * 3)) - 1) // 7
        bins_per_ref = []
        mapped_per_ref = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            bins = {}
            mapped = None
            for _ in range(n_bin):
                b, loffset, n_chunk = struct.unpack_from("<IQi", raw, pos)
                pos += 16
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", raw, pos)
                    pos += 16
                    chunks.append((beg, end))
                if b <= max_bin:
                    bins[b] = (loffset, chunks)
                elif len(chunks) == 2:
                    mapped = chunks[1][0]
            bins_per_ref.append(bins)
            mapped_per_ref.append(mapped)
        return cls(
            min_shift, depth, bins_per_ref,
            [[] for _ in bins_per_ref], mapped_per_ref,
        )

    # -- queries -------------------------------------------------------
    def chunks(self, tid: int, beg: int, end: int):
        """Merged (vbeg, vend) chunk list covering the query region."""
        if tid < 0 or tid >= len(self.bins):
            return []
        ref_bins = self.bins[tid]
        # minimum interesting virtual offset: linear index (BAI), or the
        # loffset of the deepest existing bin containing beg (CSI) — without
        # it, coarse upper-level bins make every query span the whole contig
        min_off = 0
        ioff = self.ioffsets[tid]
        if ioff:
            w = beg >> 14
            if w < len(ioff):
                min_off = ioff[w]
        else:
            t = ((1 << (self.depth * 3)) - 1) // 7
            b = t + (beg >> self.min_shift)
            while True:
                ent = ref_bins.get(b)
                if ent is not None and ent[0] > 0:
                    min_off = ent[0]
                    break
                if b == 0:
                    break
                b = (b - 1) >> 3  # parent bin
        chunks = []
        for b in reg2bins(beg, end, self.min_shift, self.depth):
            ent = ref_bins.get(b)
            if ent is None:
                continue
            loffset, cks = ent
            for cb, ce in cks:
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        merged = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged


# ---------------------------------------------------------------------------
# Index WRITING (the capture/interop side: BAMs produced by io.bam.BamWriter
# get a .bai — or .csi for contigs >= 2^29 — so both our own lazy reader and
# htslib-based tools can random-access them).


def build_index_tables(record_meta, n_ref, min_shift=14, depth=5):
    """Aggregate per-record metadata into per-ref bin/linear tables.

    record_meta: iterable of (tid, pos, end, vbeg, vend) for mapped records
    in coordinate order (vbeg/vend = BGZF virtual offsets).
    Returns (bins_per_ref, ioffsets_per_ref) in BamIndex's layout.
    """
    bins_per_ref = [dict() for _ in range(n_ref)]
    lin_per_ref = [[] for _ in range(n_ref)]
    last = (-1, -1)
    for tid, pos, end, vbeg, vend in record_meta:
        if tid < 0:
            continue
        if tid < last[0] or (tid == last[0] and pos < last[1]):
            raise ValueError("records not coordinate-sorted; cannot index")
        last = (tid, pos)
        end = max(end, pos + 1)
        b = _reg2bin_sd(pos, end, min_shift, depth)
        ent = bins_per_ref[tid].setdefault(b, [0, []])
        cks = ent[1]
        if cks and cks[-1][1] == vbeg:
            cks[-1] = (cks[-1][0], vend)  # merge file-adjacent chunks
        else:
            cks.append((vbeg, vend))
        if ent[0] == 0 or vbeg < ent[0]:
            ent[0] = vbeg  # loffset (CSI)
        lin = lin_per_ref[tid]
        for w in range(pos >> min_shift, ((end - 1) >> min_shift) + 1):
            while len(lin) <= w:
                lin.append(0)
            if lin[w] == 0 or vbeg < lin[w]:
                lin[w] = vbeg
    # fill empty linear windows with the previous value (SAM spec behavior)
    for lin in lin_per_ref:
        prev = 0
        for i, v in enumerate(lin):
            if v == 0:
                lin[i] = prev
            else:
                prev = v
    # loffset must be OVERLAP-aware (htslib semantics): a long record that
    # spans into a bin's window may live in a PARENT bin, so the min-vbeg
    # of records *contained* in the bin overstates the safe lower bound and
    # would let CSI chunk pruning drop spanning reads.  The linear table is
    # already overlap-aware — derive each bin's loffset from it.
    for tid in range(n_ref):
        lin = lin_per_ref[tid]
        for b, ent in bins_per_ref[tid].items():
            w = _bin_first_window(b, min_shift, depth)
            if w < len(lin) and lin[w]:
                ent[0] = min(ent[0], lin[w]) if ent[0] else lin[w]
    bins_out = [
        {b: (loff, cks) for b, (loff, cks) in ref.items()}
        for ref in bins_per_ref
    ]
    return bins_out, lin_per_ref


def _bin_first_window(b: int, min_shift: int, depth: int) -> int:
    """First min_shift-sized window covered by bin b."""
    level = 0
    t = 0
    while True:
        nxt = t + (1 << (level * 3))
        if b < nxt:
            break
        t = nxt
        level += 1
    beg = (b - t) << (min_shift + 3 * (depth - level))
    return beg >> min_shift


def _reg2bin_sd(beg: int, end: int, min_shift: int, depth: int) -> int:
    """reg2bin for arbitrary (min_shift, depth) (SAM spec §5.3)."""
    end -= 1
    level = depth
    s = min_shift
    while level > 0:
        if beg >> s == end >> s:
            t = ((1 << (level * 3)) - 1) // 7
            return t + (beg >> s)
        s += 3
        level -= 1
    return 0


def write_bai(path, record_meta, n_ref):
    """Write a BAI (SAM spec §5.2) for coordinate-sorted record metadata."""
    bins_per_ref, lin_per_ref = build_index_tables(record_meta, n_ref)
    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    for tid in range(n_ref):
        bins = bins_per_ref[tid]
        out += struct.pack("<i", len(bins))
        for b in sorted(bins):
            loff, cks = bins[b]
            out += struct.pack("<Ii", b, len(cks))
            for vb, ve in cks:
                out += struct.pack("<QQ", vb, ve)
        lin = lin_per_ref[tid]
        out += struct.pack("<i", len(lin))
        for v in lin:
            out += struct.pack("<Q", v)
    Path(path).write_bytes(bytes(out))


def write_csi(path, record_meta, n_ref, min_shift=14, depth=5):
    """Write a CSI (SAM spec §5.4; BGZF-compressed) index."""
    from .bam import _encode_bgzf

    bins_per_ref, _ = build_index_tables(
        record_meta, n_ref, min_shift=min_shift, depth=depth
    )
    body = bytearray(b"CSI\x01")
    body += struct.pack("<iii", min_shift, depth, 0)  # no aux
    body += struct.pack("<i", n_ref)
    for tid in range(n_ref):
        bins = bins_per_ref[tid]
        body += struct.pack("<i", len(bins))
        for b in sorted(bins):
            loff, cks = bins[b]
            body += struct.pack("<IQi", b, loff, len(cks))
            for vb, ve in cks:
                body += struct.pack("<QQ", vb, ve)
    Path(path).write_bytes(_encode_bgzf(bytes(body)))
