"""CRAM 3.0 reader/writer (pure Python + numpy).

The reference reads CRAM transparently wherever a BAM path is accepted
(rust-htslib, Cargo.toml:65). This module provides the same capability
for the TPU-native stack: a self-contained CRAM 3.0 decoder producing
``BamRecord`` objects (plugged into ``BamReader`` via the magic sniff in
``open_alignment``/``BamReader``), plus an encoder used for round-trip
tests and capture tooling.

Implemented surface (the subset htslib emits by default for short-read
data, plus what our own writer produces):

- container / block layer with CRC32s, ITF8/LTF8 varints
- block compression: raw, gzip, bzip2, lzma, rANS 4x8 (order 0 and 1 —
  the codec real-world CRAMs use for quals/bases; encoder included)
- compression header: preservation map (RN/AP/RR/SM/TD), data-series and
  tag encoding maps
- codecs: EXTERNAL, HUFFMAN (single-symbol zero-bit), BETA,
  BYTE_ARRAY_LEN, BYTE_ARRAY_STOP
- record model: paired/mate fields (detached and downstream-mate forms),
  read groups, read names, tags (via TD dictionary), mapped records as
  reference + feature list (X/I/i/D/S/H/N/P/B/b/q/Q), substitution
  matrix, soft clips, AP-delta and absolute positions, multi-ref slices
- sequence reconstruction against the reference FASTA (``RR=true``) or
  verbatim bases (``RR=false``)

- CRAI index: written by ``CramWriter.close(index=True)`` (one entry per
  slice), consumed by the lazy reader's container table
- container-granular streaming: ``CramDecoder(lazy=True)`` mmaps the
  file, scans only container headers (or the ``.crai``), and inflates
  containers on demand behind an LRU — ``BamReader`` switches to this
  path automatically at the same size threshold as lazy BAM

Out of scope (clean errors): embedded references, CRAM 3.1 codecs
(rANS Nx16, fqzcomp, name tokenizer, adaptive arithmetic).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
import zlib
from pathlib import Path

import numpy as np

from ..errors import VarlociraptorError


class MalformedCramError(VarlociraptorError):
    pass


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


def itf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes(
            [0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF]
        )
    return bytes(
        [
            0xF0 | ((v >> 28) & 0x0F),
            (v >> 20) & 0xFF,
            (v >> 12) & 0xFF,
            (v >> 4) & 0xFF,
            v & 0x0F,
        ]
    )


def ltf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16)]) + v.to_bytes(3, "big")[1:]
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24)]) + v.to_bytes(4, "big")[1:]
    if v < 0x800000000:
        return bytes([0xF0 | (v >> 32)]) + v.to_bytes(5, "big")[1:]
    if v < 0x40000000000:
        return bytes([0xF8 | (v >> 40)]) + v.to_bytes(6, "big")[1:]
    if v < 0x2000000000000:
        return bytes([0xFC | (v >> 48)]) + v.to_bytes(7, "big")[1:]
    if v < 0x100000000000000:
        return bytes([0xFE]) + v.to_bytes(8, "big")[1:]
    return bytes([0xFF]) + v.to_bytes(8, "big")


class ByteStream:
    __slots__ = ("data", "off")

    def __init__(self, data: bytes, off: int = 0):
        self.data = data
        self.off = off

    def u8(self) -> int:
        b = self.data[self.off]
        self.off += 1
        return b

    def read(self, n: int) -> bytes:
        out = self.data[self.off : self.off + n]
        if len(out) != n:
            raise MalformedCramError("truncated CRAM stream")
        self.off += n
        return out

    def itf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            return b0
        if b0 < 0xC0:
            return ((b0 & 0x7F) << 8) | self.u8()
        if b0 < 0xE0:
            return ((b0 & 0x3F) << 16) | (self.u8() << 8) | self.u8()
        if b0 < 0xF0:
            return (
                ((b0 & 0x1F) << 24)
                | (self.u8() << 16)
                | (self.u8() << 8)
                | self.u8()
            )
        v = (
            ((b0 & 0x0F) << 28)
            | (self.u8() << 20)
            | (self.u8() << 12)
            | (self.u8() << 4)
        )
        return v | (self.u8() & 0x0F)

    def itf8_signed(self) -> int:
        v = self.itf8()
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            return b0
        n = 0
        probe = b0
        while probe & 0x80:
            n += 1
            probe = (probe << 1) & 0xFF
        if n < 8:
            v = b0 & (0xFF >> (n + 1))
            for _ in range(n):
                v = (v << 8) | self.u8()
            return v
        v = 0
        for _ in range(8):
            v = (v << 8) | self.u8()
        return v

    def eof(self) -> bool:
        return self.off >= len(self.data)


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0 codec id 4)
# ---------------------------------------------------------------------------

_RANS_TF_SHIFT = 12
_RANS_TOTFREQ = 1 << _RANS_TF_SHIFT  # 4096
_RANS_LOW = 1 << 23


def _rans_write_freqs(freq: np.ndarray) -> bytes:
    out = bytearray()
    syms = np.nonzero(freq)[0]
    i = 0
    while i < len(syms):
        s = int(syms[i])
        out.append(s)
        # run-length: count consecutive symbols
        run = 0
        while i + run + 1 < len(syms) and int(syms[i + run + 1]) == s + run + 1:
            run += 1
        f = int(freq[s])
        out += itf8_encode(f)
        j = i + 1
        if run:
            # emit next symbol then RLE byte
            out.append(s + 1)
            out.append(run - 1)
            for k in range(1, run + 1):
                out += itf8_encode(int(freq[s + k]))
            j = i + run + 1
        i = j
    out.append(0)
    return bytes(out)


def _rans_read_freqs(bs: ByteStream):
    freq = np.zeros(256, dtype=np.int64)
    sym = bs.u8()
    last = -2
    rle = 0
    while True:
        f = bs.itf8()
        freq[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = bs.u8()
            if nxt == 0:
                break
            if nxt == sym + 1:
                # a second consecutive symbol: an RLE count byte follows
                rle = bs.u8()
            sym = nxt
    return freq


def _rans_norm_freqs(counts: np.ndarray) -> np.ndarray:
    total = counts.sum()
    if total == 0:
        return counts
    freq = np.maximum((counts * _RANS_TOTFREQ // total), np.where(counts > 0, 1, 0))
    # fix to sum exactly TOTFREQ
    diff = _RANS_TOTFREQ - int(freq.sum())
    order = np.argsort(-freq)
    k = 0
    while diff != 0:
        s = int(order[k % 256])
        if freq[s] > 0:
            step = 1 if diff > 0 else -1
            if freq[s] + step >= 1:
                freq[s] += step
                diff -= step
        k += 1
    return freq


def rans4x8_encode_o0(raw: bytes) -> bytes:
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    counts = np.bincount(data, minlength=256).astype(np.int64)
    freq = _rans_norm_freqs(counts)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freq, out=cum[1:])
    ftab = bytes(_rans_write_freqs(freq))
    # encode backwards, 4 interleaved states
    R = [_RANS_LOW] * 4
    out_rev = bytearray()
    for i in range(n - 1, -1, -1):
        s = int(data[i])
        j = i & 3
        x = R[j]
        f = int(freq[s])
        xmax = ((_RANS_LOW >> _RANS_TF_SHIFT) << 8) * f
        while x >= xmax:
            out_rev.append(x & 0xFF)
            x >>= 8
        R[j] = ((x // f) << _RANS_TF_SHIFT) + (x % f) + int(cum[s])
    body = bytearray()
    for j in range(4):
        body += struct.pack("<I", R[j])
    body += bytes(reversed(out_rev))
    comp = ftab + bytes(body)
    hdr = b"\x00" + struct.pack("<II", len(comp), n)
    return hdr + comp


def rans4x8_decode(raw: bytes) -> bytes:
    bs = ByteStream(raw)
    order = bs.u8()
    comp_sz = struct.unpack("<I", bs.read(4))[0]
    out_sz = struct.unpack("<I", bs.read(4))[0]
    if order == 0:
        return _rans_decode_o0(bs, out_sz)
    if order == 1:
        return _rans_decode_o1(bs, out_sz)
    raise MalformedCramError(f"rANS order {order} unsupported")


def _rans_decode_o0(bs: ByteStream, out_sz: int) -> bytes:
    freq = _rans_read_freqs(bs)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freq, out=cum[1:])
    if cum[256] != _RANS_TOTFREQ:
        raise MalformedCramError("rANS o0 freq table does not sum to 4096")
    # symbol lookup per 12-bit slot
    slot2sym = np.repeat(
        np.arange(256, dtype=np.uint8), freq.astype(np.int64)
    )
    data = bs.data
    off = bs.off
    R = list(struct.unpack("<4I", data[off : off + 16]))
    off += 16
    out = bytearray(out_sz)
    mask = _RANS_TOTFREQ - 1
    ln = len(data)
    for i in range(out_sz):
        j = i & 3
        x = R[j]
        slot = x & mask
        s = int(slot2sym[slot])
        out[i] = s
        x = int(freq[s]) * (x >> _RANS_TF_SHIFT) + slot - int(cum[s])
        while x < _RANS_LOW and off < ln:
            x = (x << 8) | data[off]
            off += 1
        R[j] = x
    return bytes(out)


def rans4x8_encode_o1(raw: bytes) -> bytes:
    data = np.frombuffer(raw, dtype=np.uint8)
    n = len(data)
    if n < 4:
        return rans4x8_encode_o0(raw)
    # order-1: contexts = previous byte; 4 interleaved streams over quarters
    q = n // 4
    starts = [0, q, 2 * q, 3 * q]
    counts = np.zeros((256, 256), dtype=np.int64)
    ctx0 = np.zeros(256, dtype=np.int64)
    for j in range(4):
        ctx0[data[starts[j]]] += 1
    prev = data[:-1]
    cur = data[1:]
    np.add.at(counts, (prev, cur), 1)
    # the first byte of quarters 1..3 is coded in its own stream with
    # context 0 in htslib; here use context = byte before it already counted.
    counts[0] += ctx0
    freq = np.zeros_like(counts)
    for c in range(256):
        if counts[c].sum():
            freq[c] = _rans_norm_freqs(counts[c])
    cum = np.zeros((256, 257), dtype=np.int64)
    np.cumsum(freq, axis=1, out=cum[:, 1:])
    # freq tables
    ft = bytearray()
    ctxs = np.nonzero(counts.sum(axis=1))[0]
    i = 0
    while i < len(ctxs):
        c = int(ctxs[i])
        ft.append(c)
        run = 0
        while i + run + 1 < len(ctxs) and int(ctxs[i + run + 1]) == c + run + 1:
            run += 1
        ft += _rans_write_freqs(freq[c])
        j = i + 1
        if run:
            ft.append(c + 1)
            ft.append(run - 1)
            for k in range(1, run + 1):
                ft += bytes(_rans_write_freqs(freq[c + k]))
            j = i + run + 1
        i = j
    ft.append(0)
    R = [_RANS_LOW] * 4
    out_rev = bytearray()
    # encode backwards; stream j covers [starts[j], ends[j])
    ends = [q, 2 * q, 3 * q, n]
    idx = [ends[j] - 1 for j in range(4)]
    # leftover tail bytes (n%4) belong to stream 3 per htslib
    total_left = sum(idx[j] - starts[j] + 1 for j in range(4))
    pos = [idx[j] for j in range(4)]
    done = [False] * 4
    # interleave: decode order is round-robin by output index; encode in
    # exact reverse: iterate positions from high to low per stream, taking
    # streams in reverse round-robin of their local index
    maxlen = max(ends[j] - starts[j] for j in range(4))
    for k in range(maxlen - 1, 0, -1):
        for j in range(3, -1, -1):
            p = starts[j] + k
            if p >= ends[j]:
                continue
            s = int(data[p])
            c = int(data[p - 1])
            x = R[j]
            f = int(freq[c, s])
            xmax = ((_RANS_LOW >> _RANS_TF_SHIFT) << 8) * f
            while x >= xmax:
                out_rev.append(x & 0xFF)
                x >>= 8
            R[j] = ((x // f) << _RANS_TF_SHIFT) + (x % f) + int(cum[c, s])
    for j in range(3, -1, -1):
        p = starts[j]
        s = int(data[p])
        c = 0
        x = R[j]
        f = int(freq[c, s])
        if f == 0:
            raise MalformedCramError("rANS o1 zero freq at stream head")
        xmax = ((_RANS_LOW >> _RANS_TF_SHIFT) << 8) * f
        while x >= xmax:
            out_rev.append(x & 0xFF)
            x >>= 8
        R[j] = ((x // f) << _RANS_TF_SHIFT) + (x % f) + int(cum[c, s])
    body = bytearray()
    for j in range(4):
        body += struct.pack("<I", R[j])
    body += bytes(reversed(out_rev))
    comp = bytes(ft) + bytes(body)
    return b"\x01" + struct.pack("<II", len(comp), n) + comp


def _rans_decode_o1(bs: ByteStream, out_sz: int) -> bytes:
    freq = np.zeros((256, 256), dtype=np.int64)
    ctx = bs.u8()
    rle = 0
    while True:
        freq[ctx] = _rans_read_freqs(bs)
        if rle > 0:
            rle -= 1
            ctx += 1
        else:
            nxt = bs.u8()
            if nxt == 0:
                break
            if nxt == ctx + 1:
                rle = bs.u8()
            ctx = nxt
    cum = np.zeros((256, 257), dtype=np.int64)
    np.cumsum(freq, axis=1, out=cum[:, 1:])
    slot2sym = np.zeros((256, _RANS_TOTFREQ), dtype=np.uint8)
    for c in range(256):
        if freq[c].sum():
            if freq[c].sum() != _RANS_TOTFREQ:
                raise MalformedCramError("rANS o1 freq table != 4096")
            slot2sym[c] = np.repeat(
                np.arange(256, dtype=np.uint8), freq[c].astype(np.int64)
            )
    data = bs.data
    off = bs.off
    R = list(struct.unpack("<4I", data[off : off + 16]))
    off += 16
    out = bytearray(out_sz)
    q = out_sz // 4
    starts = [0, q, 2 * q, 3 * q]
    ends = [q, 2 * q, 3 * q, out_sz]
    last = [0, 0, 0, 0]
    mask = _RANS_TOTFREQ - 1
    ln = len(data)
    maxlen = max(ends[j] - starts[j] for j in range(4))
    for k in range(maxlen):
        for j in range(4):
            p = starts[j] + k
            if p >= ends[j]:
                continue
            c = last[j]
            x = R[j]
            slot = x & mask
            s = int(slot2sym[c, slot])
            out[p] = s
            x = int(freq[c, s]) * (x >> _RANS_TF_SHIFT) + slot - int(cum[c, s])
            while x < _RANS_LOW and off < ln:
                x = (x << 8) | data[off]
                off += 1
            R[j] = x
            last[j] = s
    return bytes(out)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

METHOD_RAW = 0
METHOD_GZIP = 1
METHOD_BZIP2 = 2
METHOD_LZMA = 3
METHOD_RANS = 4

CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5


def write_block(method, content_type, content_id, raw: bytes) -> bytes:
    if method == METHOD_GZIP:
        comp = gzip.compress(raw, 5)
    elif method == METHOD_RANS:
        comp = rans4x8_encode_o0(raw) if raw else b""
        if not raw:
            method = METHOD_RAW
    elif method == METHOD_BZIP2:
        comp = bz2.compress(raw)
    elif method == METHOD_LZMA:
        comp = lzma.compress(raw)
    else:
        comp = raw
    body = (
        bytes([method, content_type])
        + itf8_encode(content_id)
        + itf8_encode(len(comp))
        + itf8_encode(len(raw))
        + comp
    )
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def read_block(bs: ByteStream):
    start = bs.off
    method = bs.u8()
    ctype = bs.u8()
    cid = bs.itf8()
    comp_sz = bs.itf8()
    raw_sz = bs.itf8()
    comp = bs.read(comp_sz)
    crc_calc = zlib.crc32(bs.data[start : bs.off]) & 0xFFFFFFFF
    crc = struct.unpack("<I", bs.read(4))[0]
    if crc != crc_calc:
        raise MalformedCramError("block CRC mismatch")
    if method == METHOD_RAW:
        raw = comp
    elif method == METHOD_GZIP:
        raw = gzip.decompress(comp)
    elif method == METHOD_BZIP2:
        raw = bz2.decompress(comp)
    elif method == METHOD_LZMA:
        raw = lzma.decompress(comp)
    elif method == METHOD_RANS:
        raw = rans4x8_decode(comp)
    else:
        raise MalformedCramError(f"unsupported CRAM block method {method}")
    if len(raw) != raw_sz:
        raise MalformedCramError("block raw size mismatch")
    return ctype, cid, raw


# ---------------------------------------------------------------------------
# encodings (codec descriptors)
# ---------------------------------------------------------------------------

ENC_NULL = 0
ENC_EXTERNAL = 1
ENC_HUFFMAN = 3
ENC_BYTE_ARRAY_LEN = 4
ENC_BYTE_ARRAY_STOP = 5
ENC_BETA = 6


def enc_external(cid: int) -> bytes:
    params = itf8_encode(cid)
    return itf8_encode(ENC_EXTERNAL) + itf8_encode(len(params)) + params


def enc_byte_array_stop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + itf8_encode(cid)
    return itf8_encode(ENC_BYTE_ARRAY_STOP) + itf8_encode(len(params)) + params


def enc_byte_array_len(len_enc: bytes, val_enc: bytes) -> bytes:
    params = len_enc + val_enc
    return itf8_encode(ENC_BYTE_ARRAY_LEN) + itf8_encode(len(params)) + params


def enc_huffman_const(value: int) -> bytes:
    params = (
        itf8_encode(1) + itf8_encode(value) + itf8_encode(1) + itf8_encode(0)
    )
    return itf8_encode(ENC_HUFFMAN) + itf8_encode(len(params)) + params


def parse_encoding(bs: ByteStream):
    codec = bs.itf8()
    nparams = bs.itf8()
    sub = ByteStream(bs.read(nparams))
    if codec == ENC_NULL:
        return ("null",)
    if codec == ENC_EXTERNAL:
        return ("external", sub.itf8())
    if codec == ENC_HUFFMAN:
        nsym = sub.itf8()
        syms = [sub.itf8_signed() for _ in range(nsym)]
        nlen = sub.itf8()
        lens = [sub.itf8() for _ in range(nlen)]
        return ("huffman", syms, lens)
    if codec == ENC_BYTE_ARRAY_LEN:
        len_enc = parse_encoding(sub)
        val_enc = parse_encoding(sub)
        return ("byte_array_len", len_enc, val_enc)
    if codec == ENC_BYTE_ARRAY_STOP:
        stop = sub.u8()
        cid = sub.itf8()
        return ("byte_array_stop", stop, cid)
    if codec == ENC_BETA:
        offset = sub.itf8_signed()
        nbits = sub.itf8()
        return ("beta", offset, nbits)
    raise MalformedCramError(f"unsupported CRAM encoding codec {codec}")


class CoreBits:
    """MSB-first bit reader over the core block."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


class Decoder:
    """One data-series decoder bound to its external/core stream."""

    def __init__(self, enc, ext_streams, core):
        self.enc = enc
        self.ext = ext_streams
        self.core = core
        if enc[0] == "huffman":
            syms, lens = enc[1], enc[2]
            if len(syms) == 1 and lens == [0]:
                self.const = syms[0]
            else:
                # canonical huffman over the core block
                pairs = sorted(zip(lens, syms))
                code = 0
                table = {}
                prev_len = pairs[0][0]
                for ln_, sym in pairs:
                    code <<= ln_ - prev_len
                    table[(ln_, code)] = sym
                    code += 1
                    prev_len = ln_
                self.table = table
                self.const = None

    def _stream(self, cid) -> ByteStream:
        st = self.ext.get(cid)
        if st is None:
            raise MalformedCramError(f"missing external block {cid}")
        return st

    def read_int(self) -> int:
        e = self.enc
        k = e[0]
        if k == "external":
            return self._stream(e[1]).itf8_signed()
        if k == "huffman":
            if self.const is not None:
                return self.const
            ln_, code = 0, 0
            while True:
                code = (code << 1) | self.core.bits(1)
                ln_ += 1
                sym = self.table.get((ln_, code))
                if sym is not None:
                    return sym
                if ln_ > 31:
                    raise MalformedCramError("bad huffman stream")
        if k == "beta":
            return self.core.bits(e[2]) - e[1]
        raise MalformedCramError(f"encoding {k} not valid for ints")

    def read_byte(self) -> int:
        e = self.enc
        if e[0] == "external":
            return self._stream(e[1]).u8()
        return self.read_int()

    def read_bytes(self, length=None) -> bytes:
        e = self.enc
        if e[0] == "byte_array_stop":
            st = self._stream(e[2])
            data = st.data
            end = data.index(bytes([e[1]]), st.off)
            out = data[st.off : end]
            st.off = end + 1
            return out
        if e[0] == "byte_array_len":
            ln_ = Decoder(e[1], self.ext, self.core).read_int()
            val = e[2]
            if val[0] == "external":
                return self._stream(val[1]).read(ln_)
            vdec = Decoder(val, self.ext, self.core)
            return bytes(vdec.read_byte() for _ in range(ln_))
        if e[0] == "external":
            if length is None:
                raise MalformedCramError("external byte array needs length")
            return self._stream(e[1]).read(length)
        raise MalformedCramError(f"encoding {e[0]} not valid for byte arrays")


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------

# canonical substitution-matrix base order per reference base
_SUB_BASES = {
    "A": "CGTN",
    "C": "AGTN",
    "G": "ACTN",
    "T": "ACGN",
    "N": "ACGT",
}
_REF_ORDER = "ACGTN"


class CompressionHeader:
    def __init__(self):
        self.rn = True  # read names preserved
        self.ap_delta = False
        self.rr = True  # reference required
        self.sub_matrix = bytes([0b00011011] * 5)  # identity ranking
        self.td = [[]]  # tag dictionary: list of [(tag2, type), ...]
        self.series = {}  # key (2 chars) -> encoding tuple/bytes
        self.tag_encs = {}  # int key -> encoding

    # -- substitution decode/encode
    def sub_base(self, ref_base: str, code: int) -> str:
        r = ref_base.upper() if ref_base.upper() in _REF_ORDER else "N"
        byte = self.sub_matrix[_REF_ORDER.index(r)]
        for i in range(4):
            if (byte >> (6 - 2 * i)) & 3 == code:
                return _SUB_BASES[r][i]
        return "N"

    def sub_code(self, ref_base: str, alt_base: str) -> int:
        r = ref_base.upper() if ref_base.upper() in _REF_ORDER else "N"
        a = alt_base.upper()
        byte = self.sub_matrix[_REF_ORDER.index(r)]
        bases = _SUB_BASES[r]
        i = bases.index(a) if a in bases else bases.index("N")
        return (byte >> (6 - 2 * i)) & 3


def _map_bytes(entries):
    """CRAM map: itf8 byte-size of (n + body), itf8 n, body."""
    body = bytearray()
    for key, val in entries:
        body += key
        body += val
    inner = itf8_encode(len(entries)) + bytes(body)
    return itf8_encode(len(inner)) + inner


def write_compression_header(ch: CompressionHeader) -> bytes:
    # preservation map
    pres = []
    pres.append((b"RN", bytes([1 if ch.rn else 0])))
    pres.append((b"AP", bytes([1 if ch.ap_delta else 0])))
    pres.append((b"RR", bytes([1 if ch.rr else 0])))
    pres.append((b"SM", ch.sub_matrix))
    td_body = bytearray()
    for line in ch.td:
        for tag, typ in line:
            td_body += tag.encode() + typ.encode()
        td_body.append(0)
    pres.append((b"TD", itf8_encode(len(td_body)) + bytes(td_body)))
    out = bytearray()
    out += _map_bytes(pres)
    series = [(k.encode(), v) for k, v in ch.series.items()]
    out += _map_bytes(series)
    tags = [(itf8_encode(k), v) for k, v in ch.tag_encs.items()]
    out += _map_bytes(tags)
    return bytes(out)


def parse_compression_header(raw: bytes) -> CompressionHeader:
    ch = CompressionHeader()
    bs = ByteStream(raw)
    # preservation map
    bs.itf8()  # byte size
    n = bs.itf8()
    for _ in range(n):
        key = bs.read(2)
        if key == b"RN":
            ch.rn = bs.u8() != 0
        elif key == b"AP":
            ch.ap_delta = bs.u8() != 0
        elif key == b"RR":
            ch.rr = bs.u8() != 0
        elif key == b"SM":
            ch.sub_matrix = bs.read(5)
        elif key == b"TD":
            ln_ = bs.itf8()
            body = bs.read(ln_)
            ch.td = []
            line = []
            i = 0
            while i < len(body):
                if body[i] == 0:
                    ch.td.append(line)
                    line = []
                    i += 1
                else:
                    tag = body[i : i + 2].decode("latin1")
                    typ = chr(body[i + 2])
                    line.append((tag, typ))
                    i += 3
            if not ch.td:
                ch.td = [[]]
        else:
            raise MalformedCramError(
                f"unknown preservation key {key!r}"
            )
    # data series encodings
    bs.itf8()
    n = bs.itf8()
    for _ in range(n):
        key = bs.read(2).decode("latin1")
        ch.series[key] = parse_encoding(bs)
    # tag encodings
    bs.itf8()
    n = bs.itf8()
    for _ in range(n):
        k = bs.itf8()
        ch.tag_encs[k] = parse_encoding(bs)
    return ch


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


class Container:
    def __init__(self):
        self.ref_id = -1
        self.start = 0
        self.span = 0
        self.n_records = 0
        self.counter = 0
        self.bases = 0
        self.n_blocks = 0
        self.blocks_data = b""
        self.landmarks = []
        self.blocks_off = 0  # payload position in the file (lazy scan)
        self.blocks_len = 0


def write_container(c: Container) -> bytes:
    hdr = bytearray()
    hdr += struct.pack("<i", len(c.blocks_data))
    hdr += itf8_encode(c.ref_id & 0xFFFFFFFF)
    hdr += itf8_encode(c.start)
    hdr += itf8_encode(c.span)
    hdr += itf8_encode(c.n_records)
    hdr += ltf8_encode(c.counter)
    hdr += ltf8_encode(c.bases)
    hdr += itf8_encode(c.n_blocks)
    hdr += itf8_encode(len(c.landmarks))
    for lm in c.landmarks:
        hdr += itf8_encode(lm)
    hdr += struct.pack("<I", zlib.crc32(bytes(hdr)) & 0xFFFFFFFF)
    return bytes(hdr) + c.blocks_data


def read_container_header(bs: ByteStream, skip_blocks: bool = False):
    """Parse one container header; with ``skip_blocks`` the payload is NOT
    materialized — ``c.blocks_off``/``c.blocks_len`` record where it lives
    (the lazy streaming scan; decode happens on demand)."""
    start = bs.off
    c = Container()
    length = struct.unpack("<i", bs.read(4))[0]
    c.ref_id = bs.itf8_signed()
    c.start = bs.itf8()
    c.span = bs.itf8()
    c.n_records = bs.itf8()
    c.counter = bs.ltf8()
    c.bases = bs.ltf8()
    c.n_blocks = bs.itf8()
    nlm = bs.itf8()
    c.landmarks = [bs.itf8() for _ in range(nlm)]
    crc_calc = zlib.crc32(bs.data[start : bs.off]) & 0xFFFFFFFF
    crc = struct.unpack("<I", bs.read(4))[0]
    if crc != crc_calc:
        raise MalformedCramError("container header CRC mismatch")
    c.blocks_off = bs.off
    c.blocks_len = length
    if skip_blocks:
        if bs.off + length > len(bs.data):
            raise MalformedCramError("container payload exceeds file size")
        bs.off += length
    else:
        c.blocks_data = bs.read(length)
    return c


# ---------------------------------------------------------------------------
# CRAI index (gzipped TSV: seq_id, start, span, container byte offset,
# slice byte offset within the container payload, slice size)
# ---------------------------------------------------------------------------


def write_crai(entries, path) -> None:
    with gzip.open(path, "wt") as f:
        for e in entries:
            print("\t".join(str(int(x)) for x in e), file=f)


def read_crai(path):
    out = []
    with gzip.open(path, "rt") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                out.append(tuple(int(x) for x in parts[:6]))
    return out


# data series 2-char keys
_INT_SERIES = [
    "BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS", "NF",
    "TL", "FN", "FP", "DL", "HC", "PD", "RS", "MQ", "EC",
]
_BYTE_SERIES = ["FC", "BS", "BA", "QS", "QQ"]


# ---------------------------------------------------------------------------
# slice header
# ---------------------------------------------------------------------------


class SliceHeader:
    def __init__(self):
        self.ref_id = -1
        self.start = 0
        self.span = 0
        self.n_records = 0
        self.counter = 0
        self.n_blocks = 0
        self.content_ids = []
        self.embedded_ref_id = -1
        self.md5 = b"\x00" * 16
        self.tags = b""


def write_slice_header(sh: SliceHeader) -> bytes:
    out = bytearray()
    out += itf8_encode(sh.ref_id & 0xFFFFFFFF)
    out += itf8_encode(sh.start)
    out += itf8_encode(sh.span)
    out += itf8_encode(sh.n_records)
    out += ltf8_encode(sh.counter)
    out += itf8_encode(sh.n_blocks)
    out += itf8_encode(len(sh.content_ids))
    for cid in sh.content_ids:
        out += itf8_encode(cid)
    out += itf8_encode(sh.embedded_ref_id & 0xFFFFFFFF)
    out += sh.md5
    out += sh.tags
    return bytes(out)


def parse_slice_header(raw: bytes) -> SliceHeader:
    bs = ByteStream(raw)
    sh = SliceHeader()
    sh.ref_id = bs.itf8_signed()
    sh.start = bs.itf8()
    sh.span = bs.itf8()
    sh.n_records = bs.itf8()
    sh.counter = bs.ltf8()
    sh.n_blocks = bs.itf8()
    n = bs.itf8()
    sh.content_ids = [bs.itf8() for _ in range(n)]
    sh.embedded_ref_id = bs.itf8_signed()
    sh.md5 = bs.read(16)
    sh.tags = bs.data[bs.off :]
    return sh


# ---------------------------------------------------------------------------
# record codec
# ---------------------------------------------------------------------------

# CRAM record CF flags
CF_QS_PRESERVED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8

# CRAM mate flags (MF)
MF_MATE_REVERSE = 0x1
MF_MATE_UNMAPPED = 0x2

# BAM flag bits NOT carried in the CRAM BF series (recomputed from mate
# info): 0x8 mate unmapped, 0x20 mate reverse (spec: these two are
# stripped from BF and restored via MF/detached logic; we keep the rest).
_BF_STRIP = 0x8 | 0x20

_CIGAR_OP = {c: i for i, c in enumerate("MIDNSHP=X")}


class _SeriesWriters:
    """Per-series output buffers for the writer (all EXTERNAL)."""

    def __init__(self):
        self.bufs = {}

    def ints(self, key, v):
        self.bufs.setdefault(key, bytearray()).extend(itf8_encode(v & 0xFFFFFFFF))

    def byte(self, key, b):
        self.bufs.setdefault(key, bytearray()).append(b)

    def raw(self, key, data):
        self.bufs.setdefault(key, bytearray()).extend(data)


def _tag_value_bytes(typ: str, val) -> bytes:
    """BAM-layout value bytes for a tag (without tag/type prefix)."""
    if typ == "A":
        return (val if isinstance(val, str) else chr(val)).encode("latin1")[:1]
    if typ == "c":
        return struct.pack("<b", int(val))
    if typ == "C":
        return struct.pack("<B", int(val))
    if typ == "s":
        return struct.pack("<h", int(val))
    if typ == "S":
        return struct.pack("<H", int(val))
    if typ == "i":
        return struct.pack("<i", int(val))
    if typ == "I":
        return struct.pack("<I", int(val))
    if typ == "f":
        return struct.pack("<f", float(val))
    if typ == "Z":
        return str(val).encode("latin1") + b"\x00"
    if typ == "B":
        arr = np.asarray(val)
        if arr.dtype.kind == "f":
            sub, fmt = b"f", "<f"
            vals = arr.astype(np.float32)
        else:
            sub, fmt = b"i", "<i"
            vals = arr.astype(np.int64)
        out = sub + struct.pack("<I", len(vals))
        for v in vals:
            out += struct.pack(fmt, v if fmt == "<f" else int(v))
        return out
    raise MalformedCramError(f"unsupported tag type {typ}")


def _tag_type_of(val) -> str:
    if isinstance(val, bool):
        return "i"
    if isinstance(val, (int, np.integer)):
        return "i"
    if isinstance(val, (float, np.floating)):
        return "f"
    if isinstance(val, np.ndarray):
        return "B"
    return "Z"


def _parse_tag_value(typ: str, data: bytes):
    if typ == "A":
        return data[:1].decode("latin1")
    if typ == "c":
        return struct.unpack("<b", data[:1])[0]
    if typ == "C":
        return struct.unpack("<B", data[:1])[0]
    if typ == "s":
        return struct.unpack("<h", data[:2])[0]
    if typ == "S":
        return struct.unpack("<H", data[:2])[0]
    if typ == "i":
        return struct.unpack("<i", data[:4])[0]
    if typ == "I":
        return struct.unpack("<I", data[:4])[0]
    if typ == "f":
        return struct.unpack("<f", data[:4])[0]
    if typ == "Z":
        end = data.index(b"\x00") if b"\x00" in data else len(data)
        return data[:end].decode("latin1")
    if typ == "B":
        sub = chr(data[0])
        n = struct.unpack("<I", data[1:5])[0]
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
        return np.frombuffer(data[5 : 5 + n * struct.calcsize(fmt)], dtype=np.dtype(fmt))
    raise MalformedCramError(f"unsupported tag type {typ}")


_TAG_SIZE = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

# fixed external content ids per series (writer side)
_SERIES_IDS = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "MF": 7,
    "NS": 8, "NP": 9, "TS": 10, "NF": 11, "TL": 12, "FN": 13, "FP": 14,
    "FC": 15, "DL": 16, "HC": 17, "PD": 18, "RS": 19, "MQ": 20,
    "BA": 21, "QS": 22, "BS": 23, "IN": 24, "SC": 25, "BB": 26, "QQ": 27,
    "RN": 28, "EC": 29,
}
_TAG_ID_BASE = 0x100000


class CramWriter:
    """CRAM 3.0 encoder over BamRecord streams.

    Every data series is EXTERNAL in its own block; RN via
    BYTE_ARRAY_STOP('\\t'); tags via BYTE_ARRAY_LEN(EXTERNAL, EXTERNAL).
    QS/BA blocks use rANS 4x8, everything else gzip. Mapped records are
    stored reference-based (features vs the given FASTA); all records are
    written mate-detached (MF/NS/NP/TS explicit), which is always valid.
    """

    def __init__(self, path, ref_names, ref_lengths, reference=None,
                 header_text: str = "", records_per_container: int = 4096):
        self.path = Path(path)
        self.ref_names = list(ref_names)
        self.ref_lengths = [int(l) for l in ref_lengths]
        self.reference = reference  # FastaBuffer or dict name->np.uint8 array
        self.rpc = records_per_container
        self._fh = open(self.path, "wb")
        self._pending = []
        self._counter = 0
        self._crai_entries = []
        if not header_text:
            lines = ["@HD\tVN:1.6\tSO:coordinate"]
            for n, l in zip(self.ref_names, self.ref_lengths):
                lines.append(f"@SQ\tSN:{n}\tLN:{l}")
            header_text = "\n".join(lines) + "\n"
        self.header_text = header_text
        self._fh.write(b"CRAM\x03\x00" + self.path.name.encode("latin1")[:20].ljust(20, b"\x00"))
        # file header container: SAM text in one block, int32 length prefix
        text = header_text.encode("latin1")
        raw = struct.pack("<i", len(text)) + text
        blk = write_block(METHOD_RAW, CT_FILE_HEADER, 0, raw)
        c = Container()
        c.ref_id = 0 if self.ref_names else -1
        c.n_blocks = 1
        c.blocks_data = blk
        c.landmarks = [0]
        self._fh.write(write_container(c))

    def _ref_seq(self, tid):
        if self.reference is None:
            return None
        name = self.ref_names[tid]
        try:
            if isinstance(self.reference, dict):
                return self.reference[name]
            return self.reference.seq(name)
        except KeyError:
            # contig in the BAM header but absent from the FASTA: store
            # such records verbatim ('b' features), like htslib does when
            # the reference slice is unavailable
            return None

    def write_record(self, rec):
        self._pending.append(rec)
        if len(self._pending) >= self.rpc:
            self._flush()

    # -- container emission -------------------------------------------
    def _flush(self):
        if not self._pending:
            return
        recs = self._pending
        self._pending = []
        # split runs by tid so each slice is single-ref
        runs = []
        cur = [recs[0]]
        for r in recs[1:]:
            if r.tid != cur[0].tid:
                runs.append(cur)
                cur = [r]
            else:
                cur.append(r)
        runs.append(cur)
        for run in runs:
            self._write_container(run)

    def _write_container(self, recs):
        ch = CompressionHeader()
        # tag dictionary
        td = []
        td_index = {}
        tls = []
        for r in recs:
            line = tuple(
                (k, _tag_type_of(v)) for k, v in sorted(r.tags.items())
            )
            if line not in td_index:
                td_index[line] = len(td)
                td.append(list(line))
            tls.append(td_index[line])
        ch.td = td if td else [[]]

        sw = _SeriesWriters()
        tag_bufs = {}
        ref_id = recs[0].tid
        ref = self._ref_seq(ref_id) if ref_id >= 0 else None
        starts = [r.pos for r in recs if r.tid >= 0]
        ap_lo = min(starts) if starts else 0
        ap_hi = max((r.pos + max(r.cigar_ref_len(), 1)) for r in recs if r.tid >= 0) if starts else 0
        nbases = 0

        for r, tl in zip(recs, tls):
            nbases += len(r.seq)
            bf = r.flag & ~_BF_STRIP
            cf = CF_DETACHED | CF_QS_PRESERVED
            sw.ints("BF", bf)
            sw.ints("CF", cf)
            sw.ints("RL", len(r.seq))
            sw.ints("AP", r.pos if r.tid >= 0 else 0)
            sw.ints("RG", -1)
            sw.raw("RN", r.qname.encode("latin1") + b"\t")
            mf = 0
            if r.flag & 0x20:
                mf |= MF_MATE_REVERSE
            if r.flag & 0x8:
                mf |= MF_MATE_UNMAPPED
            sw.ints("MF", mf)
            sw.ints("NS", r.mtid)
            sw.ints("NP", r.mpos)
            sw.ints("TS", r.tlen)
            sw.ints("TL", tl)
            # tags
            for k, v in sorted(r.tags.items()):
                typ = _tag_type_of(v)
                key = (ord(k[0]) << 16) | (ord(k[1]) << 8) | ord(typ)
                buf = tag_bufs.setdefault(key, bytearray())
                vb = _tag_value_bytes(typ, v)
                buf += itf8_encode(len(vb)) + vb
            if r.tid < 0 or r.flag & 0x4 or not r.cigar:
                # unmapped: verbatim bases
                sw.raw("BA", bytes(r.seq))
            else:
                self._write_features(sw, r, ref)
                sw.ints("MQ", r.mapq)
            sw.raw("QS", bytes(np.where(r.qual == 255, 255, r.qual).astype(np.uint8)))

        # encodings map
        ch.series = {}
        for key in ("BF", "CF", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
                    "TL", "FN", "FP", "DL", "HC", "PD", "RS", "MQ", "EC"):
            if key in sw.bufs:
                ch.series[key] = enc_external(_SERIES_IDS[key])
        for key in ("FC", "BS"):
            if key in sw.bufs:
                ch.series[key] = enc_external(_SERIES_IDS[key])
        for key in ("BA", "QS"):
            if key in sw.bufs:
                ch.series[key] = enc_external(_SERIES_IDS[key])
        if "RN" in sw.bufs:
            ch.series["RN"] = enc_byte_array_stop(ord("\t"), _SERIES_IDS["RN"])
        for key in ("IN", "SC", "BB", "QQ"):
            if key in sw.bufs:
                ch.series[key] = enc_byte_array_stop(0, _SERIES_IDS[key])
        # tag encodings: BYTE_ARRAY_LEN(len=EXTERNAL(id), val=EXTERNAL(id))
        tag_ids = {}
        for i, key in enumerate(sorted(tag_bufs)):
            cid = _TAG_ID_BASE + i
            tag_ids[key] = cid
            ch.tag_encs[key] = enc_byte_array_len(
                enc_external(cid), enc_external(cid)
            )

        ch_raw = write_compression_header(ch)
        ch_block = write_block(METHOD_GZIP, CT_COMPRESSION_HEADER, 0, ch_raw)

        # slice
        ext_ids = [
            _SERIES_IDS[k] for k in sorted(sw.bufs, key=lambda k: _SERIES_IDS[k])
        ] + [tag_ids[k] for k in sorted(tag_bufs)]
        sh = SliceHeader()
        sh.ref_id = ref_id
        sh.start = ap_lo if ref_id >= 0 else 0
        sh.span = (ap_hi - ap_lo) if ref_id >= 0 else 0
        sh.n_records = len(recs)
        sh.counter = self._counter
        sh.n_blocks = 1 + len(ext_ids)  # core + externals
        sh.content_ids = ext_ids
        blocks = bytearray()
        blocks += write_block(METHOD_RAW, CT_CORE, 0, b"")
        for k in sorted(sw.bufs, key=lambda k: _SERIES_IDS[k]):
            method = METHOD_RANS if k in ("QS", "BA") else METHOD_GZIP
            blocks += write_block(method, CT_EXTERNAL, _SERIES_IDS[k], bytes(sw.bufs[k]))
        for k in sorted(tag_bufs):
            blocks += write_block(METHOD_GZIP, CT_EXTERNAL, tag_ids[k], bytes(tag_bufs[k]))
        sh_block = write_block(METHOD_RAW, CT_SLICE_HEADER, 0, write_slice_header(sh))

        c = Container()
        c.ref_id = ref_id
        c.start = sh.start
        c.span = sh.span
        c.n_records = len(recs)
        c.counter = self._counter
        c.bases = nbases
        c.n_blocks = 1 + 1 + sh.n_blocks  # comp header + slice header + slice blocks
        c.landmarks = [len(ch_block)]
        c.blocks_data = ch_block + sh_block + bytes(blocks)
        self._crai_entries.append(
            (
                ref_id,
                sh.start,
                sh.span,
                self._fh.tell(),
                len(ch_block),
                len(sh_block) + len(blocks),
            )
        )
        self._fh.write(write_container(c))
        self._counter += len(recs)

    def _write_features(self, sw, r, ref):
        """Reference-based features for a mapped record."""
        feats = []  # (pos1_in_read, code, payload)
        qpos = 0  # 0-based read offset
        rpos = r.pos
        seq = r.seq
        for op, ln_ in r.cigar:
            if op in (0, 7, 8):  # M, =, X
                if ref is None:
                    feats.append((qpos + 1, b"b", bytes(seq[qpos : qpos + ln_])))
                else:
                    for k in range(ln_):
                        rb = int(ref[rpos + k]) if rpos + k < len(ref) else ord("N")
                        qb = int(seq[qpos + k])
                        if (qb & 0xDF) != (rb & 0xDF):
                            feats.append((qpos + k + 1, b"X", (chr(rb & 0xDF), chr(qb & 0xDF))))
                qpos += ln_
                rpos += ln_
            elif op == 1:  # I
                if ln_ == 1:
                    feats.append((qpos + 1, b"i", bytes(seq[qpos : qpos + 1])))
                else:
                    feats.append((qpos + 1, b"I", bytes(seq[qpos : qpos + ln_])))
                qpos += ln_
            elif op == 2:  # D
                feats.append((qpos + 1, b"D", ln_))
                rpos += ln_
            elif op == 3:  # N
                feats.append((qpos + 1, b"N", ln_))
                rpos += ln_
            elif op == 4:  # S
                feats.append((qpos + 1, b"S", bytes(seq[qpos : qpos + ln_])))
                qpos += ln_
            elif op == 5:  # H
                feats.append((qpos + 1, b"H", ln_))
            elif op == 6:  # P
                feats.append((qpos + 1, b"P", ln_))
            else:
                raise MalformedCramError(f"cigar op {op} unsupported in CRAM writer")
        sw.ints("FN", len(feats))
        last = 0
        for pos1, code, payload in feats:
            sw.byte("FC", code[0])
            sw.ints("FP", pos1 - last)
            last = pos1
            if code == b"X":
                sw.byte("BS", CompressionHeader().sub_code(payload[0], payload[1]))
            elif code == b"I":
                sw.raw("IN", payload + b"\x00")
            elif code in (b"i",):
                sw.raw("BA", payload)
            elif code == b"S":
                sw.raw("SC", payload + b"\x00")
            elif code == b"D":
                sw.ints("DL", payload)
            elif code == b"N":
                sw.ints("RS", payload)
            elif code == b"H":
                sw.ints("HC", payload)
            elif code == b"P":
                sw.ints("PD", payload)
            elif code == b"b":
                sw.raw("BB", payload + b"\x00")

    def close(self, index: bool = False):
        """Finish the stream; ``index=True`` also writes ``<path>.crai``
        (one entry per slice, matching the BamWriter BAI/CSI story)."""
        self._flush()
        # EOF container (sentinel values per spec: ref -1, start 4542278,
        # one raw compression-header block of 6 bytes)
        eofc = Container()
        eofc.ref_id = -1
        eofc.start = 4542278
        eofc.span = 0
        eofc.n_records = 0
        eofc.counter = 0
        eofc.bases = 0
        eofc.n_blocks = 1
        eofc.landmarks = []
        eofc.blocks_data = write_block(
            METHOD_RAW, CT_COMPRESSION_HEADER, 0, b"\x01\x00\x01\x00\x01\x00"
        )
        self._fh.write(write_container(eofc))
        self._fh.close()
        if index:
            write_crai(
                self._crai_entries, str(self.path) + ".crai"
            )


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def is_cram(path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"CRAM"
    except OSError:
        return False


class CramDecoder:
    """Decodes a CRAM 3.x file into (header_text, ref_names, ref_lengths,
    records). Needs the reference FASTA (FastaBuffer or dict) whenever a
    container was written reference-based (RR=true).

    ``lazy=True`` switches to container-granular streaming (the rust-htslib
    CRAM capability, Cargo.toml:65): the file is memory-mapped, only
    container HEADERS are scanned up front (or taken from a sibling
    ``.crai`` when present), and payload decode happens on demand behind a
    small LRU — ``fetch()`` on a WGS-scale CRAM touches only the overlapping
    containers instead of inflating the whole file."""

    _LRU_CONTAINERS = 4

    def __init__(self, path, reference=None, lazy: bool = False):
        self.path = Path(path)
        self.reference = reference
        self.lazy = bool(lazy)
        if self.lazy:
            import mmap

            self._fh = open(self.path, "rb")
            try:
                data = mmap.mmap(
                    self._fh.fileno(), 0, access=mmap.ACCESS_READ
                )
            except (ValueError, OSError):  # empty file etc.
                data = self._fh.read()
        else:
            data = self.path.read_bytes()
        self._data = data
        if data[:4] != b"CRAM":
            raise MalformedCramError(f"{path}: not a CRAM file")
        self.major, self.minor = data[4], data[5]
        if self.major not in (2, 3):
            raise MalformedCramError(
                f"CRAM major version {self.major} unsupported"
            )
        bs = ByteStream(data, 6 + 20)
        # file header container
        c0 = read_container_header(bs)
        cbs = ByteStream(c0.blocks_data)
        ctype, _, raw = read_block(cbs)
        if ctype != CT_FILE_HEADER:
            raise MalformedCramError("first container lacks SAM header block")
        text_len = struct.unpack("<i", raw[:4])[0]
        self.header_text = raw[4 : 4 + text_len].decode("latin1").rstrip("\x00")
        self.ref_names = []
        self.ref_lengths = []
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                fields = dict(
                    f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                )
                if "SN" in fields:
                    self.ref_names.append(fields["SN"])
                    self.ref_lengths.append(int(fields.get("LN", 0)))
        if self.lazy:
            self.records = None
            self._containers = self._scan_containers(bs)
            self._cache: dict = {}
            return
        self.records = []
        counter = 0
        while not bs.eof():
            c = read_container_header(bs)
            if c.ref_id == -1 and c.start == 4542278 and c.n_records == 0:
                break  # EOF container
            if c.n_records == 0 and not c.blocks_data:
                continue
            self._decode_container(c, self.records)
            counter += c.n_records

    # -- lazy container table -------------------------------------------
    def _scan_containers(self, bs: ByteStream):
        """[(file_off, ref_id, start, span, n_records)] for every data
        container.  Uses the sibling ``.crai``'s container offsets when
        present (slice entries grouped by container; CRAI read path);
        otherwise one cheap header-only scan (no payload decompression)."""
        crai_path = Path(str(self.path) + ".crai")
        out = []
        if crai_path.exists():
            seen = set()
            for seq_id, start, span, coff, _soff, _ssz in read_crai(crai_path):
                if coff in seen:
                    continue  # multi-slice container: one entry suffices
                seen.add(coff)
                out.append((coff, seq_id, start, span, None))
            out.sort()
            return out
        while not bs.eof():
            off = bs.off
            c = read_container_header(bs, skip_blocks=True)
            if c.ref_id == -1 and c.start == 4542278 and c.n_records == 0:
                break  # EOF container
            if c.n_records == 0 and c.blocks_len == 0:
                continue
            out.append((off, c.ref_id, c.start, c.span, c.n_records))
        return out

    def _container_records(self, i: int):
        """Decode (with LRU) the records of container table entry ``i``."""
        got = self._cache.get(i)
        if got is not None:
            self._cache[i] = self._cache.pop(i)  # refresh recency
            return got
        off = self._containers[i][0]
        bs = ByteStream(self._data, off)
        c = read_container_header(bs)
        recs: list = []
        if c.n_records or c.blocks_data:
            self._decode_container(c, recs)
        self._cache[i] = recs
        if len(self._cache) > self._LRU_CONTAINERS:
            self._cache.pop(next(iter(self._cache)))
        return recs

    def iter_records(self):
        for i in range(len(self._containers)):
            yield from self._container_records(i)

    def count_records(self) -> int:
        n = 0
        for i, meta in enumerate(self._containers):
            if meta[4] is not None:
                n += meta[4]
            else:
                n += len(self._container_records(i))
        return n

    def fetch(self, tid: int, start: int, end: int):
        """Records overlapping [start, end) on tid, start-ordered; decodes
        only containers whose indexed span overlaps (or multi-ref ones)."""
        out = []
        for i, (_off, ref_id, c_start, c_span, _n) in enumerate(
            self._containers
        ):
            if ref_id == -1:
                continue  # unmapped-only container
            if ref_id >= 0 and ref_id != tid:
                continue
            if ref_id == tid and c_span and not (
                c_start < end and c_start + c_span > start
            ):
                continue
            for rec in self._container_records(i):
                if rec.tid == tid and rec.end_pos > start and rec.pos < end:
                    out.append(rec)
        out.sort(key=lambda r: r.pos)
        return out

    def _ref_seq(self, tid):
        if tid < 0:
            return None
        if self.reference is None:
            raise MalformedCramError(
                "CRAM container requires the reference FASTA (RR=true); "
                "pass reference= to CramDecoder/BamReader"
            )
        name = self.ref_names[tid]
        try:
            if isinstance(self.reference, dict):
                return self.reference[name]
            return self.reference.seq(name)
        except KeyError:
            return None

    def _decode_container(self, c: Container, out: list):
        bs = ByteStream(c.blocks_data)
        ctype, _, raw = read_block(bs)
        if ctype != CT_COMPRESSION_HEADER:
            raise MalformedCramError("expected compression header block")
        ch = parse_compression_header(raw)
        while not bs.eof():
            ctype, _, raw = read_block(bs)
            if ctype != CT_SLICE_HEADER:
                raise MalformedCramError("expected slice header block")
            sh = parse_slice_header(raw)
            core = None
            ext = {}
            for _ in range(sh.n_blocks):
                btype, cid, braw = read_block(bs)
                if btype == CT_CORE:
                    core = CoreBits(braw)
                elif btype == CT_EXTERNAL:
                    ext[cid] = ByteStream(braw)
                else:
                    raise MalformedCramError(
                        f"unexpected block type {btype} in slice"
                    )
            if sh.embedded_ref_id >= 0:
                raise MalformedCramError(
                    "embedded-reference CRAM slices are not supported"
                )
            self._decode_slice(ch, sh, core, ext, out)

    def _decode_slice(self, ch, sh, core, ext, out: list):
        from .bam import BamRecord

        def dec(key):
            e = ch.series.get(key)
            return Decoder(e, ext, core) if e is not None else None

        d = {k: dec(k) for k in (
            "BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP",
            "TS", "NF", "TL", "FN", "FP", "FC", "BS", "IN", "SC", "BB",
            "QQ", "BA", "QS", "DL", "RS", "HC", "PD", "MQ", "EC",
        )}
        tag_decs = {k: Decoder(e, ext, core) for k, e in ch.tag_encs.items()}
        multiref = sh.ref_id == -2
        prev_ap = sh.start
        recs_meta = []
        for ri in range(sh.n_records):
            bf = d["BF"].read_int()
            cf = d["CF"].read_int()
            tid = d["RI"].read_int() if multiref else sh.ref_id
            rl = d["RL"].read_int()
            ap = d["AP"].read_int()
            if ch.ap_delta:
                ap = prev_ap + ap
                prev_ap = ap
            d["RG"].read_int() if d["RG"] else None
            if ch.rn and d["RN"] is not None:
                qname = d["RN"].read_bytes().decode("latin1")
            else:
                qname = f"cram.{sh.counter + ri}"
            mtid, mpos, tlen = -1, -1, 0
            mate_flags = 0
            nf = None
            if cf & CF_DETACHED:
                mate_flags = d["MF"].read_int()
                if not ch.rn and d["RN"] is not None:
                    qname = d["RN"].read_bytes().decode("latin1")
                mtid = d["NS"].read_int()
                mpos = d["NP"].read_int()
                tlen = d["TS"].read_int()
            elif cf & CF_MATE_DOWNSTREAM:
                nf = d["NF"].read_int()
            tl = d["TL"].read_int() if d["TL"] else 0
            tags = {}
            if ch.td and tl < len(ch.td):
                for tag, typ in ch.td[tl]:
                    key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                    td_dec = tag_decs.get(key)
                    if td_dec is None:
                        raise MalformedCramError(f"no encoding for tag {tag}:{typ}")
                    raw = td_dec.read_bytes()
                    tags[tag] = _parse_tag_value(typ, raw)
            flag = bf
            if mate_flags & MF_MATE_REVERSE:
                flag |= 0x20
            if mate_flags & MF_MATE_UNMAPPED:
                flag |= 0x8
            unmapped = bool(bf & 0x4)
            if not unmapped:
                # features
                fn = d["FN"].read_int()
                feats = []
                last = 0
                for _ in range(fn):
                    fc = d["FC"].read_byte()
                    fp = d["FP"].read_int()
                    last += fp
                    code = chr(fc)
                    if code == "X":
                        feats.append((last, "X", d["BS"].read_byte()))
                    elif code == "I":
                        feats.append((last, "I", d["IN"].read_bytes()))
                    elif code == "i":
                        feats.append((last, "i", bytes([d["BA"].read_byte()])))
                    elif code == "S":
                        feats.append((last, "S", d["SC"].read_bytes()))
                    elif code == "D":
                        feats.append((last, "D", d["DL"].read_int()))
                    elif code == "N":
                        feats.append((last, "N", d["RS"].read_int()))
                    elif code == "H":
                        feats.append((last, "H", d["HC"].read_int()))
                    elif code == "P":
                        feats.append((last, "P", d["PD"].read_int()))
                    elif code == "b":
                        feats.append((last, "b", d["BB"].read_bytes()))
                    elif code == "q":
                        feats.append((last, "q", d["QQ"].read_bytes()))
                    elif code == "B":
                        base = d["BA"].read_byte()
                        qual = d["QS"].read_byte()
                        feats.append((last, "B", (base, qual)))
                    elif code == "Q":
                        feats.append((last, "Q", d["QS"].read_byte()))
                    else:
                        raise MalformedCramError(f"feature code {code!r} unsupported")
                mq = d["MQ"].read_int()
                seq, cigar, qual_over = self._reconstruct(
                    ch, tid, ap, rl, feats
                )
            else:
                mq = 0
                seq = bytes(d["BA"].read_bytes(rl)) if rl else b""
                cigar = []
                qual_over = {}
            if cf & CF_QS_PRESERVED and d["QS"] is not None:
                qual = np.frombuffer(
                    d["QS"].read_bytes(rl), dtype=np.uint8
                ).copy()
            else:
                qual = np.full(rl, 255, np.uint8)
                for qpos, qv in qual_over.items():
                    qual[qpos] = qv
            rec = BamRecord(
                qname=qname,
                flag=flag,
                tid=tid,
                pos=(ap if not unmapped or tid >= 0 else -1),
                mapq=mq,
                cigar=cigar,
                mtid=mtid,
                mpos=mpos,
                tlen=tlen,
                seq=np.frombuffer(
                    seq if isinstance(seq, bytes) else bytes(seq), dtype=np.uint8
                ).copy(),
                qual=qual,
                tags=tags,
            )
            recs_meta.append((rec, nf))
            out.append(rec)
        # resolve downstream mates (NF): record i's mate is record i+1+nf
        for i, (rec, nf) in enumerate(recs_meta):
            if nf is None:
                continue
            j = i + 1 + nf
            if j >= len(recs_meta):
                raise MalformedCramError("NF mate index out of slice")
            mate = recs_meta[j][0]
            rec.mtid, rec.mpos = mate.tid, mate.pos
            mate.mtid, mate.mpos = rec.tid, rec.pos
            if mate.flag & 0x10:
                rec.flag |= 0x20
            if rec.flag & 0x10:
                mate.flag |= 0x20
            lo = min(rec.pos, mate.pos)
            hi = max(rec.pos + rec.cigar_ref_len(), mate.pos + mate.cigar_ref_len())
            rec.tlen = hi - lo if rec.pos <= mate.pos else -(hi - lo)
            mate.tlen = -rec.tlen

    def _reconstruct(self, ch, tid, ap, rl, feats):
        """Rebuild seq + cigar from reference and features."""
        ref = self._ref_seq(tid) if ch.rr else None
        seq = bytearray(rl)
        cigar = []
        qual_over = {}

        def push(op, n):
            if n <= 0:
                return
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + n)
            else:
                cigar.append((op, n))

        qpos = 0  # 0-based
        rpos = ap  # 0-based ref
        def fill_match(n):
            nonlocal qpos, rpos
            if n <= 0:
                return
            if ref is None:
                raise MalformedCramError(
                    "reference-based CRAM record but no reference available"
                )
            for k in range(n):
                seq[qpos + k] = (
                    int(ref[rpos + k]) & 0xDF if rpos + k < len(ref) else ord("N")
                )
            push(0, n)
            qpos += n
            rpos += n

        for pos1, code, payload in feats:
            gap = (pos1 - 1) - qpos
            fill_match(gap)
            if code == "X":
                rb = chr(int(ref[rpos]) & 0xDF) if ref is not None and rpos < len(ref) else "N"
                seq[qpos] = ord(ch.sub_base(rb, payload))
                push(0, 1)
                qpos += 1
                rpos += 1
            elif code in ("I", "i"):
                seq[qpos : qpos + len(payload)] = payload
                push(1, len(payload))
                qpos += len(payload)
            elif code == "S":
                seq[qpos : qpos + len(payload)] = payload
                push(4, len(payload))
                qpos += len(payload)
            elif code == "D":
                push(2, payload)
                rpos += payload
            elif code == "N":
                push(3, payload)
                rpos += payload
            elif code == "H":
                push(5, payload)
            elif code == "P":
                push(6, payload)
            elif code == "b":
                seq[qpos : qpos + len(payload)] = payload
                push(0, len(payload))
                qpos += len(payload)
                rpos += len(payload)
            elif code == "q":
                for k, qv in enumerate(payload):
                    qual_over[qpos + k] = qv
            elif code == "B":
                base, qv = payload
                seq[qpos] = base
                qual_over[qpos] = qv
                push(0, 1)
                qpos += 1
                rpos += 1
            elif code == "Q":
                qual_over[qpos] = payload
        fill_match(rl - qpos)
        return bytes(seq), cigar, qual_over
