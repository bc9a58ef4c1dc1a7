"""ctypes bindings for the native host runtime (native/vlt_native.cpp).

Lazily compiles the shared library on first use (g++ -O3, links zlib +
pthread) and caches it next to the source; falls back to pure Python when no
compiler is available. The native path parallelizes BGZF inflation — the
dominant host cost when feeding pileups to the device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "vlt_native.cpp"
_LIB = _NATIVE_DIR.parent.parent / "build" / "torch_native" / "libvlt_native.so"

_lib = None
_tried = False


def _default_threads(cap: int) -> int:
    env = os.environ.get("VLT_NATIVE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return min(cap, os.cpu_count() or 1)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            subprocess.run(
                [
                    "g++",
                    "-O3",
                    "-shared",
                    "-fPIC",
                    "-std=c++17",
                    str(_SRC),
                    "-o",
                    str(_LIB),
                    "-lz",
                    "-lpthread",
                ],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(str(_LIB))
        lib.vlt_bgzf_index.restype = ctypes.c_int64
        lib.vlt_bgzf_inflate.restype = ctypes.c_int32
        lib.vlt_bam_scan.restype = ctypes.c_int64
        lib.vlt_semiglobal_edit.restype = ctypes.c_int32
        lib.vlt_pairhmm_forward_batch.restype = ctypes.c_int32
        lib.vlt_pairhmm_forward_batch_log.restype = ctypes.c_int32
        lib.vlt_myers_semiglobal.restype = ctypes.c_int32
        lib.vlt_hybrid_hits_batch.restype = ctypes.c_int32
        lib.vlt_pairhmm_hop_batch.restype = ctypes.c_int32
        _lib = lib
    except Exception:  # noqa: BLE001 - fall back to pure python
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def bgzf_decompress(data: bytes, nthreads: int | None = None) -> bytes | None:
    """Parallel BGZF decompression; None if native lib unavailable or the
    input isn't clean BGZF (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    nthreads = nthreads or min(8, os.cpu_count() or 1)
    buf = np.frombuffer(data, dtype=np.uint8)
    max_blocks = max(16, len(data) // 64)
    offsets = np.zeros(max_blocks, dtype=np.int64)
    csizes = np.zeros(max_blocks, dtype=np.int32)
    usizes = np.zeros(max_blocks, dtype=np.int32)
    n = lib.vlt_bgzf_index(
        buf.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(data)),
        offsets.ctypes.data_as(ctypes.c_void_p),
        csizes.ctypes.data_as(ctypes.c_void_p),
        usizes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(max_blocks),
    )
    if n <= 0:
        return None
    total_in = int(offsets[n - 1] + csizes[n - 1])
    if total_in != len(data):
        return None  # trailing plain-gzip member etc.: fall back
    out_offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(usizes[: n - 1], out=out_offsets[1:]) if n > 1 else None
    total = int(out_offsets[-1] + usizes[n - 1]) if n else 0
    out = np.zeros(total, dtype=np.uint8)
    rc = lib.vlt_bgzf_inflate(
        buf.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        csizes.ctypes.data_as(ctypes.c_void_p),
        usizes.ctypes.data_as(ctypes.c_void_p),
        out_offsets.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int32(nthreads),
    )
    if rc != 0:
        return None
    return out.tobytes()


def bam_scan(data: bytes, start: int):
    """Columnar BAM record index: (offsets, tids, positions, end_positions,
    flags, mapqs) or None."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    max_records = max(16, (len(data) - start) // 36 + 1)
    offsets = np.zeros(max_records, dtype=np.int64)
    tids = np.zeros(max_records, dtype=np.int32)
    positions = np.zeros(max_records, dtype=np.int32)
    end_positions = np.zeros(max_records, dtype=np.int32)
    flags = np.zeros(max_records, dtype=np.uint16)
    mapqs = np.zeros(max_records, dtype=np.uint8)
    n = lib.vlt_bam_scan(
        buf.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(data)),
        ctypes.c_int64(start),
        offsets.ctypes.data_as(ctypes.c_void_p),
        tids.ctypes.data_as(ctypes.c_void_p),
        positions.ctypes.data_as(ctypes.c_void_p),
        end_positions.ctypes.data_as(ctypes.c_void_p),
        flags.ctypes.data_as(ctypes.c_void_p),
        mapqs.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(max_records),
    )
    if n < 0:
        return None
    return (
        offsets[:n].copy(),
        tids[:n].copy(),
        positions[:n].copy(),
        end_positions[:n].copy(),
        flags[:n].copy(),
        mapqs[:n].copy(),
    )



def _pack_batch(alleles, reads, miscalls, max_edit):
    """Shared buffer packing for the pair-HMM batch entry points: offsets,
    concatenated sequence/miscall buffers, and the band sentinel array."""
    n = len(alleles)
    a_len = np.array([len(a) for a in alleles], dtype=np.int32)
    r_len = np.array([len(r) for r in reads], dtype=np.int32)
    a_off = np.zeros(n, dtype=np.int64)
    np.cumsum(a_len[:-1], out=a_off[1:])
    r_off = np.zeros(n, dtype=np.int64)
    np.cumsum(r_len[:-1], out=r_off[1:])
    def _as_u8(x):
        if isinstance(x, (bytes, bytearray, memoryview)):
            return np.frombuffer(bytes(x), dtype=np.uint8)
        return np.asarray(x, dtype=np.uint8)

    a_buf = np.frombuffer(b"".join(bytes(a) for a in alleles), dtype=np.uint8)
    r_buf = (
        np.concatenate([_as_u8(r) for r in reads])
        if reads
        else np.zeros(0, np.uint8)
    )
    m_buf = (
        np.concatenate([np.asarray(m, dtype=np.float32) for m in miscalls])
        if miscalls is not None
        else None
    )
    me_buf = None
    if max_edit is not None:
        me_buf = np.array(
            [-1 if d is None else int(d) for d in max_edit], dtype=np.int32
        )
    return a_len, r_len, a_off, r_off, a_buf, r_buf, m_buf, me_buf


def pairhmm_forward_batch(
    alleles,
    reads,
    miscalls,
    gaps,
    ins_open=None,
    ins_ext=None,
    del_open=None,
    del_ext=None,
    max_edit=None,
    n_threads=None,
    profile="linear",
):
    """Native linear-space semiglobal pair-HMM forward over a work batch.

    ``profile="log"`` selects the f64 log-space per-cell ln_sum_exp twin
    (the rust-bio LogProb numeric profile; same recurrence and banding).

    alleles/reads: list[bytes]; miscalls: list[float32 arrays] (log miscall
    per read base); gaps: [4] log f32.  Optional positional gap arrays
    (homopolymer mode): ins_open/ins_ext per read base, del_open/del_ext per
    allele base (lists of f32 arrays).  ``max_edit``: optional per-item
    int band (None entries / -1 = full forward); cells whose min edit
    distance exceeds it are pruned exactly like rust-bio's banded
    PairHMM (realignment/mod.rs:526-543).  Returns np.float64 [n]
    log-probs, or None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(alleles)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    a_len, r_len, a_off, r_off, a_buf, r_buf, m_buf, me_buf = _pack_batch(
        alleles, reads, miscalls, max_edit
    )
    gaps32 = np.asarray(gaps, dtype=np.float32)
    out = np.zeros(n, dtype=np.float64)

    def _cat(parts, dtype=np.float32):
        if parts is None:
            return None
        return np.concatenate([np.asarray(p, dtype=dtype) for p in parts])

    io_buf = _cat(ins_open)
    ie_buf = _cat(ins_ext)
    do_buf = _cat(del_open)
    de_buf = _cat(del_ext)

    def _ptr(arr):
        return (
            arr.ctypes.data_as(ctypes.c_void_p)
            if arr is not None
            else ctypes.c_void_p(None)
        )

    nthreads = n_threads or _default_threads(8)
    fn = (
        lib.vlt_pairhmm_forward_batch_log
        if profile == "log"
        else lib.vlt_pairhmm_forward_batch
    )
    rc = fn(
        a_buf.ctypes.data_as(ctypes.c_void_p),
        a_off.ctypes.data_as(ctypes.c_void_p),
        a_len.ctypes.data_as(ctypes.c_void_p),
        r_buf.ctypes.data_as(ctypes.c_void_p),
        r_off.ctypes.data_as(ctypes.c_void_p),
        r_len.ctypes.data_as(ctypes.c_void_p),
        m_buf.ctypes.data_as(ctypes.c_void_p),
        gaps32.ctypes.data_as(ctypes.c_void_p),
        _ptr(io_buf),
        _ptr(ie_buf),
        _ptr(do_buf),
        _ptr(de_buf),
        _ptr(me_buf),
        ctypes.c_int32(n),
        ctypes.c_int32(nthreads),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return out


def myers_semiglobal(pattern: bytes, text: bytes):
    """Myers bit-parallel semiglobal distance (edit_distance.rs:132-158):
    pattern fully consumed, free start/end gaps in text. Returns
    (dist, first_end, last_end) — 1-based first/last co-optimal end text
    columns — or None (native lib missing / pattern > 128)."""
    lib = _load()
    if lib is None or not pattern or not text or len(pattern) > 128:
        return None
    fe = ctypes.c_int32()
    le = ctypes.c_int32()
    dist = lib.vlt_myers_semiglobal(
        ctypes.c_char_p(pattern),
        ctypes.c_int32(len(pattern)),
        ctypes.c_char_p(text),
        ctypes.c_int32(len(text)),
        ctypes.byref(fe),
        ctypes.byref(le),
    )
    if dist < 0:
        return None
    return int(dist), int(fe.value), int(le.value)


def semiglobal_edit_hybrid(allele: bytes, read: bytes):
    """Myers distance scan + windowed traceback DP: for long allele windows
    the bit-parallel scan finds the co-optimal end columns and the O(nm)
    DP only runs on the hit windows.  Falls back to the plain DP for short
    windows (where the full DP is already cheaper) or when the native
    library is unavailable."""
    if len(allele) >= 256 and len(read) <= 128:
        my = myers_semiglobal(read, allele)
        if my is not None:
            dist, fe, le = my
            lo1 = max(0, fe - len(read) - dist)
            r1 = semiglobal_edit(allele[lo1:fe], read)
            if r1 is not None:
                d1, s1, ops1, _ = r1
                if le > fe:
                    lo2 = max(0, le - len(read) - dist)
                    r2 = semiglobal_edit(allele[lo2:le], read)
                    last_start = lo2 + r2[3] if r2 is not None else lo1 + s1
                else:
                    last_start = lo1 + s1
                return dist, lo1 + s1, ops1, last_start
    return semiglobal_edit(allele, read)


def semiglobal_edit(allele: bytes, read: bytes):
    """Native semiglobal edit DP; returns (dist, start, ops list) or None."""
    lib = _load()
    if lib is None:
        return None
    X, Y = len(allele), len(read)
    out_start = ctypes.c_int32()
    out_n = ctypes.c_int32()
    out_last_start = ctypes.c_int32()
    ops_buf = (ctypes.c_uint8 * (X + Y + 2))()
    dist = lib.vlt_semiglobal_edit(
        ctypes.c_char_p(allele),
        ctypes.c_int32(X),
        ctypes.c_char_p(read),
        ctypes.c_int32(Y),
        ctypes.byref(out_start),
        ops_buf,
        ctypes.byref(out_n),
        ctypes.byref(out_last_start),
    )
    if dist < 0:
        return None
    return (
        int(dist),
        int(out_start.value),
        list(ops_buf[: out_n.value]),
        int(out_last_start.value),
    )


def hybrid_hits_batch(alleles, reads, n_threads=None):
    """Batched semiglobal_edit_hybrid + co-optimal suffix alignment: ONE
    library call for a whole allele set (the per-call ctypes overhead of
    semiglobal_edit dominates the edit-distance pre-pass otherwise).

    alleles/reads: list[bytes].  Returns a list of
    ``(dist, start, ops, last_start, second)`` with ``second`` either None
    or ``(dist2, start2_rel_to_last_start, ops2)`` — exactly the parts
    consumed by evidence.edit_distance.finish_hit — or None when the native
    library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(alleles)
    if n == 0:
        return []
    a_len, r_len, a_off, r_off, a_buf, r_buf, _m, _me = _pack_batch(
        alleles, reads, None, None
    )
    strides = (a_len + r_len + 2).astype(np.int64)
    ops_off = np.zeros(n, dtype=np.int64)
    np.cumsum(strides[:-1], out=ops_off[1:])
    total_ops = int(ops_off[-1] + strides[-1])
    out_dist = np.zeros(n, dtype=np.int32)
    out_start = np.zeros(n, dtype=np.int32)
    out_last = np.zeros(n, dtype=np.int32)
    out_nops = np.zeros(n, dtype=np.int32)
    out_ops = np.zeros(total_ops, dtype=np.uint8)
    out_dist2 = np.zeros(n, dtype=np.int32)
    out_start2 = np.zeros(n, dtype=np.int32)
    out_nops2 = np.zeros(n, dtype=np.int32)
    out_ops2 = np.zeros(total_ops, dtype=np.uint8)
    rc = lib.vlt_hybrid_hits_batch(
        a_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        a_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        r_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        r_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        r_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n),
        ctypes.c_int32(n_threads or _default_threads(4)),
        out_dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_last.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_nops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ops_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_dist2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_start2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_nops2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_ops2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None
    out = []
    for b in range(n):
        o = int(ops_off[b])
        ops = list(out_ops[o : o + int(out_nops[b])])
        second = None
        if int(out_dist2[b]) >= 0:
            second = (
                int(out_dist2[b]),
                int(out_start2[b]),
                list(out_ops2[o : o + int(out_nops2[b])]),
            )
        out.append(
            (int(out_dist[b]), int(out_start[b]), ops, int(out_last[b]), second)
        )
    return out


def pairhmm_hop_batch(alleles, reads, miscalls, gaps, hop16, max_edit=None,
                      n_threads=None):
    """Native hop-state homopolymer pair-HMM forward (HomopolyPairHMM
    reconstruction; see native/vlt_native.cpp::vlt_pairhmm_hop_one).

    hop16: [16] log probs — seq hop open[ACGT], seq hop extend[ACGT],
    ref hop open[ACGT], ref hop extend[ACGT]. Returns np.float64 [n] or
    None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(alleles)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    a_len, r_len, a_off, r_off, a_buf, r_buf, m_buf, me_buf = _pack_batch(
        alleles, reads, miscalls, max_edit
    )
    gaps32 = np.asarray(gaps, dtype=np.float32)
    hop32 = np.asarray(hop16, dtype=np.float32)
    assert hop32.shape == (16,)
    out = np.zeros(n, dtype=np.float64)
    rc = lib.vlt_pairhmm_hop_batch(
        a_buf.ctypes.data_as(ctypes.c_void_p),
        a_off.ctypes.data_as(ctypes.c_void_p),
        a_len.ctypes.data_as(ctypes.c_void_p),
        r_buf.ctypes.data_as(ctypes.c_void_p),
        r_off.ctypes.data_as(ctypes.c_void_p),
        r_len.ctypes.data_as(ctypes.c_void_p),
        m_buf.ctypes.data_as(ctypes.c_void_p),
        gaps32.ctypes.data_as(ctypes.c_void_p),
        hop32.ctypes.data_as(ctypes.c_void_p),
        me_buf.ctypes.data_as(ctypes.c_void_p)
        if me_buf is not None
        else ctypes.c_void_p(None),
        ctypes.c_int32(1 if os.environ.get("VLT_HOP_EMIT") == "1" else 0),
        ctypes.c_int32(n),
        ctypes.c_int32(n_threads or _default_threads(4)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return out
