"""The banded log-space pair-HMM wavefronts: banded, positional and hop-state.

Counterpart of the XLA wavefronts of ``varlociraptor_tpu/ops/pairhmm.py``:
``_forward_impl`` (:55-189, constant gaps), ``_forward_hp_impl`` (:193-336,
per-position gap panels) and ``_forward_hop_impl`` (:340-502, the hop-state
homopolymer model with the HX and HY lanes).  Each marches the X + Y
anti-diagonals k of the (allele i, read j) grid in log space in float32,
cell (i, j) = (k - j, j), with the model of :mod:`.pairhmm`, and carries the
int32 edit-distance DP on the same diagonals: a cell whose three
predecessors all exceed the item's ``max_edit`` is pruned (rust-bio's banded
PairHMM); ``max_edit < 0`` means no band, and column j = 0 anchors a free
start (distance 0) while k <= allele_len.  The result sums the end cells
j == read_len over all diagonals (free end on the allele axis).

The plain torch versions here (:func:`banded_forward_reference`,
:func:`positional_banded_forward_reference`, :func:`hop_forward_reference`)
follow the JAX scan body line by line on [B, W] tensors, W = Yp + 1, one
diagonal per step, with the ``_lse2`` / ``_lse3`` formulas (:40-51).  The
hand-written kernel ``csrc/pairhmm_wavefront.cu`` computes the same cells in
the same order of float32 operations, one block per item and one thread per
read column.  The wrappers (:func:`banded_forward`,
:func:`positional_banded_forward`, :func:`hop_forward`) take the plain
version for a CPU tensor and the kernel for a CUDA tensor, or raise.

A diagonal past allele_len + read_len holds no valid end cell, and adding
-1e30 to the sum leaves it bit for bit as it was, so both march only to
the longest item's allele_len + read_len; a column past read_len never feeds
one at or before it.  Inputs, as the JAX package packs them (:693-719,
:784-807; :func:`pack_wavefront`): allele [B, Xp] uint8 upper-cased (0
padding), alen [B] int32, read [B, Yp] uint8 upper-cased, mis [B, Yp]
float32 log miscall (-1e30 padding), rlen [B] int32, max_edit [B] int32;
gaps [4] float32 log (t_mi, t_md, t_ii, t_dd); the positional flavour's LOG
panels io / ie [B, Yp] and do / de [B, Xp]; the hop flavour's hop16 [16]
(:func:`hop16`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .pairhmm_column import to_device

NEG_INF = -1.0e30  # finite -inf proxy (f32-safe)
EINF = 1 << 29  # "unreachable" edit distance
LN_CONFUSION = math.log(0.3333)
LN_QUARTER = math.log(0.25)
_N = ord("N")
_BASE_IDX = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T
# the kernel keeps the allele bytes (and the positional flavour's deletion
# panels) of one item in shared memory: 227 KB a block on an H100
MAX_SMEM = 227 * 1024
# columns per thread the kernel is instantiated for (one block of at most
# 1024 threads takes an item of up to 1024 * C read columns)
COLS_PER_THREAD = (1, 2, 4, 8, 16, 32)
FLAVOURS = ("banded", "positional", "hop")


def _round_up(x, m):
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# host packing (numpy), as the JAX package packs its wavefront calls
# ---------------------------------------------------------------------------


def pack_wavefront(alleles, reads, quals, max_dists=None):
    """Ragged work items -> (allele, alen, read, mis, rlen, max_edit) numpy
    panels, as ``BatchedPairHMM.forward`` packs them for ``_forward_impl``
    (:693-719): upper-cased bytes, Xp and Yp the longest allele and read
    rounded up to 32 (at least 32), miscall = -q * ln(10) / 10 in float64
    stored as float32, -1e30 past each read, max_edit -1 (no band) where
    ``max_dists`` is None or holds None.  The JAX package pads the batch to a
    power of two (at least 8) with length-1 items so that its compiled
    programs are reused; the values do not depend on it, and here the batch
    is the item count."""
    n = len(alleles)
    X = _round_up(max(max((len(a) for a in alleles), default=1), 1), 32)
    Y = _round_up(max(max((len(r) for r in reads), default=1), 1), 32)
    allele = np.zeros((n, X), dtype=np.uint8)
    alen = np.zeros(n, dtype=np.int32)
    read = np.zeros((n, Y), dtype=np.uint8)
    rlen = np.zeros(n, dtype=np.int32)
    mis = np.full((n, Y), NEG_INF, dtype=np.float32)
    medge = np.full(n, -1, dtype=np.int32)
    if max_dists is not None:
        for b, d in enumerate(max_dists):
            if d is not None:
                medge[b] = int(d)
    for b in range(n):
        a = np.frombuffer(bytes(alleles[b]), dtype=np.uint8)
        r = np.asarray(reads[b], dtype=np.uint8)
        q = np.asarray(quals[b], dtype=np.float64)
        allele[b, : len(a)] = a & ~np.uint8(0x20)  # uppercase
        alen[b] = len(a)
        read[b, : len(r)] = r & ~np.uint8(0x20)
        rlen[b] = len(r)
        mis[b, : len(q)] = -q * math.log(10.0) / 10.0
    return allele, alen, read, mis, rlen, medge


def positional_gaps(seqs, base_open, base_ext, hop_open, hop_ext):
    """Per-position LOG gap open / extend of packed sequences (host numpy),
    ``varlociraptor_tpu/ops/pairhmm.py:BatchedPairHMM._positional_gaps``
    (:884-900): the base rates everywhere (padding included), and inside a
    homopolymer run (a byte equal to the one before it, not 0) the larger of
    the base rate and that base's hop rate, where the hop rate is finite.
    seqs: [B, N] uint8; hop_open / hop_ext: LOG rates per base (A, C, G, T).
    Returns (open, ext), each [B, N] float32."""
    B, N = seqs.shape
    open_arr = np.full((B, N), base_open, dtype=np.float32)
    ext_arr = np.full((B, N), base_ext, dtype=np.float32)
    same = np.zeros((B, N), dtype=bool)
    same[:, 1:] = (seqs[:, 1:] == seqs[:, :-1]) & (seqs[:, 1:] != 0)
    for base_ascii, bi in _BASE_IDX.items():
        sel = same & (seqs == base_ascii)
        ho = hop_open[bi]
        he = hop_ext[bi]
        if math.isfinite(ho):
            open_arr[sel] = np.maximum(open_arr[sel], np.float32(ho))
        if math.isfinite(he):
            ext_arr[sel] = np.maximum(ext_arr[sel], np.float32(he))
    return open_arr, ext_arr


def positional_panels(allele, read, gap, hop):
    """The positional flavour's LOG panels of packed upper-cased panels, as
    the JAX wavefront route builds them (:720-728): (io, ie) from the read
    side (gap[0] / gap[2] and ``prob_seq_*``), (do, de) from the allele side
    (gap[1] / gap[3] and ``prob_ref_*``)."""
    io, ie = positional_gaps(read, gap[0], gap[2], hop.prob_seq_homopolymer,
                             hop.prob_seq_extend_homopolymer)
    do, de = positional_gaps(allele, gap[1], gap[3], hop.prob_ref_homopolymer,
                             hop.prob_ref_extend_homopolymer)
    return io, ie, do, de


def hop16(hop):
    """[16] float32 LOG hop probabilities of ``HopParams``: seq open (A, C, G,
    T), seq extend, ref open, ref extend; anything not finite is -1e30
    (``BatchedPairHMM._hop16``, :580-594)."""
    def _f(vals):
        return [v if (v is not None and math.isfinite(v)) else NEG_INF for v in vals]

    return np.array(
        _f(hop.prob_seq_homopolymer) + _f(hop.prob_seq_extend_homopolymer)
        + _f(hop.prob_ref_homopolymer) + _f(hop.prob_ref_extend_homopolymer),
        dtype=np.float32,
    )


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _lse2(a, b):
    m = torch.maximum(a, b)
    out = m + torch.log1p(torch.exp(-torch.abs(a - b)))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _close(x):
    """log(max(1 - exp(x), 1e-12)): the probability of leaving a state."""
    return torch.log(torch.clamp(1.0 - torch.exp(x), min=1e-12))


def _shift(x, fill):
    """x at column j - 1 (``fill`` shifted in at j = 0)."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _table(vals4, dev):
    """256-entry per-byte table: vals4 at A, C, G, T, -1e30 elsewhere."""
    t = torch.full((256,), NEG_INF, dtype=torch.float32, device=dev)
    for bi, ch in enumerate(b"ACGT"):
        t[ch] = vals4[bi]
    return t


def _wavefront_reference(allele, alen, read, mis, rlen, max_edit, gaps=None,
                         panels=None, hop=None, stats=None):
    """The scan body of ``_forward_impl`` (``gaps``), ``_forward_hp_impl``
    (``panels`` = LOG io, ie, do, de) or ``_forward_hop_impl`` (``gaps`` and
    ``hop`` = hop16) on [B, W] tensors.  Returns [B] float32.  With
    ``stats``, adds the cells computed (not pruned by the band) to
    ``stats["cells"]``."""
    B, X = allele.shape
    Y = read.shape[1]
    W = Y + 1
    dev = allele.device
    f32 = torch.float32
    if B == 0:
        return torch.zeros(0, dtype=f32, device=dev)
    j_idx = torch.arange(W, device=dev)[None, :]
    alen_ = alen.to(torch.int64)[:, None]
    rlen_ = rlen.to(torch.int64)[:, None]
    neg1 = torch.full((B, 1), NEG_INF, dtype=f32, device=dev)
    no_call = torch.log1p(-torch.exp(mis))
    mis_j = torch.cat([neg1, mis], dim=1)
    noc_j = torch.cat([neg1, no_call], dim=1)
    read_j = torch.cat([torch.zeros((B, 1), dtype=torch.uint8, device=dev), read], dim=1)
    is_n = read_j == _N
    allele_l = allele.to(torch.int64)
    if panels is None:
        t_mi, t_md, t_ii, t_dd = (gaps[k] for k in range(4))
        t_mm = torch.log(torch.clamp(1.0 - torch.exp(t_mi) - torch.exp(t_md), min=1e-12))
        t_im = _close(t_ii)
        t_dm = _close(t_dd)
    else:
        io, ie, do, de = panels
        ins_open_j = torch.cat([neg1, io], dim=1)
        ins_ext_j = torch.cat([neg1, ie], dim=1)
        t_im = _close(ins_ext_j)
        t_mi, t_ii = ins_open_j, ins_ext_j
        do_pad = torch.cat([do, torch.full((B, 1), NEG_INF, dtype=f32, device=dev)], dim=1)
        de_pad = torch.cat([de, torch.full((B, 1), NEG_INF, dtype=f32, device=dev)], dim=1)
    if hop is not None:
        hox_t, hex_t, hoy_t, hey_t = (_table(hop[4 * q: 4 * q + 4], dev) for q in range(4))
        read_jl = read_j.to(torch.int64)
        # the read base before column j's (read[j - 2]); 0 at j <= 1
        read_jp = torch.cat(
            [torch.zeros((B, 2), dtype=torch.int64, device=dev),
             read.to(torch.int64)[:, :-1]], dim=1)
        hox_r = hox_t[read_jl]
        hex_r = hex_t[read_jl]
        same_read = (read_jl == read_jp) & (read_jl != 0)
        hxclose = _close(hex_t[read_jp])
    me = torch.where(max_edit < 0, EINF, max_edit).to(torch.int64)[:, None]
    neg = torch.full((B, W), NEG_INF, dtype=f32, device=dev)
    einf = torch.full((B, W), EINF, dtype=torch.int64, device=dev)
    M2 = D2 = I2 = M1 = D1 = I1 = HX2 = HY2 = HX1 = HY1 = neg
    E2 = einf
    E1 = einf.clone()
    E1[:, 0] = 0
    acc = torch.full((B,), NEG_INF, dtype=f32, device=dev)
    rows = torch.arange(B, device=dev)
    at_end = rlen.to(torch.int64)
    start_col = j_idx == 1
    cells = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(1, int((alen.to(torch.int64) + rlen.to(torch.int64)).max()) + 1):
        i = k - j_idx
        in_read = (j_idx >= 1) & (j_idx <= rlen_)
        valid = in_read & (i >= 1) & (i <= alen_)
        valid_i0 = in_read & (i == 0)
        pos = k - 1 - j_idx  # allele index i - 1
        inr = (pos >= 0) & (pos < X)
        ab = torch.where(inr, allele_l[:, pos.clamp(0, X - 1)[0]], 0)
        match = ab == read_j
        e_m = torch.where(match, noc_j, torch.where(is_n, LN_QUARTER, mis_j + LN_CONFUSION))
        if panels is not None:
            pidx = torch.where(inr, pos, X)[0]
            d_open = do_pad[:, pidx]
            d_ext = de_pad[:, pidx]
            t_mm = torch.log(
                torch.clamp(1.0 - torch.exp(ins_open_j) - torch.exp(d_open), min=1e-12))
            t_dm = _close(d_ext)
            t_md, t_dd = d_open, d_ext
        M2s, D2s, I2s = _shift(M2, NEG_INF), _shift(D2, NEG_INF), _shift(I2, NEG_INF)
        start_m = torch.where(start_col, 0.0, NEG_INF)
        inner = _lse3(t_mm + M2s, t_dm + D2s, t_im + I2s)
        if hop is not None:
            posp = pos - 1  # allele index i - 2
            abp = torch.where((posp >= 0) & (posp < X), allele_l[:, posp.clamp(0, X - 1)[0]], 0)
            hyclose_p = _close(hey_t[abp])
            HX2s, HY2s = _shift(HX2, NEG_INF), _shift(HY2, NEG_INF)
            inner = _lse2(inner, _lse2(hxclose + HX2s, hyclose_p + HY2s))
        Mk = torch.where(valid, e_m + _lse2(inner, start_m), NEG_INF)
        Dk = torch.where(valid, _lse2(t_md + M1, t_dd + D1), NEG_INF)
        M1s, I1s = _shift(M1, NEG_INF), _shift(I1, NEG_INF)
        start_i = torch.where(start_col, t_mi, NEG_INF)
        Ik = mis_j + _lse2(_lse2(t_mi + M1s, t_ii + I1s), start_i)
        Ik = torch.where(valid | valid_i0, Ik, NEG_INF)
        if hop is not None:
            HX1s = _shift(HX1, NEG_INF)
            hx_entry = torch.where(match, hox_r + M1s, NEG_INF)
            hx_ext = torch.where(same_read, hex_r + HX1s, NEG_INF)
            HXk = torch.where(valid, _lse2(hx_entry, hx_ext), NEG_INF)
            same_allele = (ab == abp) & (ab != 0)
            hy_in = torch.where(same_allele, _lse2(hoy_t[ab] + M1, hey_t[ab] + HY1), NEG_INF)
            HYk = torch.where(valid, hy_in, NEG_INF)
        # edit-distance DP + banded skip (rust-bio PairHMM min_edit_dist)
        E2s, E1s = _shift(E2, EINF), _shift(E1, EINF)
        pred_min = torch.minimum(torch.minimum(E2s, E1s), E1)
        skip = pred_min > me
        sub = torch.where(match, E2s, torch.clamp(E2s + 1, max=EINF))
        Ek = torch.minimum(sub, torch.clamp(torch.minimum(E1s, E1) + 1, max=EINF))
        cell_ok = (valid | valid_i0) & ~skip
        Ek = torch.where(cell_ok, Ek, EINF)
        if stats is not None:
            cells += cell_ok.sum()
        Ek[:, 0] = torch.where(alen.to(torch.int64) >= k, 0, EINF)
        Mk = torch.where(skip, NEG_INF, Mk)
        Dk = torch.where(skip, NEG_INF, Dk)
        Ik = torch.where(skip, NEG_INF, Ik)
        fin = _lse2(Mk, Ik)
        if hop is not None:
            HXk = torch.where(skip, NEG_INF, HXk)
            HYk = torch.where(skip, NEG_INF, HYk)
            fin = _lse2(fin, HXk)
            HX2, HY2, HX1, HY1 = HX1, HY1, HXk, HYk
        # the end cell j == read_len of this diagonal (free end gap in x)
        acc = _lse2(acc, fin[rows, at_end])
        M2, D2, I2, M1, D1, I1 = M1, D1, I1, Mk, Dk, Ik
        E2, E1 = E1, Ek
    if stats is not None:
        stats["cells"] = stats.get("cells", 0) + int(cells.item())
    return acc


def banded_forward_reference(allele, alen, read, mis, rlen, gaps, max_edit):
    """Plain torch ``_forward_impl``: [B] float32 log forward probabilities
    with the constant LOG gaps [4] (t_mi, t_md, t_ii, t_dd)."""
    return _wavefront_reference(allele, alen, read, mis, rlen, max_edit, gaps=gaps)


def positional_banded_forward_reference(allele, alen, read, mis, rlen, io, ie, do, de,
                                        max_edit):
    """Plain torch ``_forward_hp_impl``: [B] float32 log forward probabilities
    with the LOG gap panels io / ie [B, Yp] and do / de [B, Xp]."""
    return _wavefront_reference(allele, alen, read, mis, rlen, max_edit,
                                panels=(io, ie, do, de))


def hop_forward_reference(allele, alen, read, mis, rlen, gaps, hop, max_edit):
    """Plain torch ``_forward_hop_impl``: [B] float32 log forward
    probabilities of the hop-state model, LOG gaps [4] and hop16 [16]."""
    return _wavefront_reference(allele, alen, read, mis, rlen, max_edit, gaps=gaps, hop=hop)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def cols_per_thread(Yp):
    """Read columns per thread for a read panel of Yp: the fewest that let
    one block of at most 1024 threads take the Yp + 1 columns."""
    for c in COLS_PER_THREAD:
        if 1024 * c >= Yp + 1:
            return c
    raise ValueError(f"wavefront: read panel width {Yp} exceeds the kernel's bound of "
                     f"{1024 * COLS_PER_THREAD[-1] - 1}")


def smem_bytes(flavour, Xp):
    """Dynamic shared memory of a block: the allele bytes, and for the
    positional flavour the deletion open / extend panels (float32)."""
    return (8 * Xp if flavour == "positional" else 0) + _round_up(Xp, 16)


def _check(name, flavour, allele, alen, read, mis, rlen, max_edit, floats):
    specs = [("allele", allele, torch.uint8), ("alen", alen, torch.int32),
             ("read", read, torch.uint8), ("mis", mis, torch.float32),
             ("rlen", rlen, torch.int32), ("max_edit", max_edit, torch.int32)]
    specs += [(nm, t, torch.float32) for nm, t in floats]
    for nm, t, dt in specs:
        if t.dtype != dt:
            raise TypeError(f"{name}: {nm} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.device != allele.device:
            raise ValueError(f"{name}: {nm} on {t.device}, allele on {allele.device}")
    if allele.dim() != 2 or read.dim() != 2 or mis.shape != read.shape:
        raise ValueError(
            f"{name}: allele [B, Xp], read and mis [B, Yp] expected, got "
            f"{tuple(allele.shape)}, {tuple(read.shape)}, {tuple(mis.shape)}")
    B, Xp = allele.shape
    if (read.shape[0] != B or alen.shape != (B,) or rlen.shape != (B,)
            or max_edit.shape != (B,)):
        raise ValueError(f"{name}: batch sizes differ")
    cols_per_thread(read.shape[1])
    if smem_bytes(flavour, Xp) > MAX_SMEM:
        raise ValueError(f"{name}: allele panel width {Xp} exceeds the kernel's shared "
                         f"memory bound of {MAX_SMEM} bytes")


def _launch(flavour, allele, alen, read, mis, rlen, max_edit, gaps, hop, panels):
    """Launch ``vlt_pairhmm_wavefront`` on the current stream."""
    from .._build import load

    lib = load()
    B, Xp = allele.shape
    Yp = read.shape[1]
    out = torch.empty(B, dtype=torch.float32, device=allele.device)
    if B == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    io, ie, do, de = panels if panels is not None else (None,) * 4
    args = (allele, alen, read, mis, rlen, max_edit, gaps, hop, io, ie, do, de)
    with torch.cuda.device(allele.device):
        stream = torch.cuda.current_stream(allele.device).cuda_stream
        err = lib.vlt_pairhmm_wavefront(FLAVOURS.index(flavour), *map(ptr, args),
                                        out.data_ptr(), B, Xp, Yp, stream)
    if err != 0:
        raise RuntimeError(f"vlt_pairhmm_wavefront ({flavour}) kernel launch failed: "
                           f"CUDA error {err}")
    return out


def _dispatch(fn, flavour, reference, allele, alen, read, mis, rlen, max_edit, gaps=None,
              hop=None, panels=None):
    floats = ([("gaps", gaps)] if gaps is not None else []) + (
        [("hop16", hop)] if hop is not None else []) + (
        list(zip(("io", "ie", "do", "de"), panels)) if panels is not None else [])
    _check(fn.__name__, flavour, allele, alen, read, mis, rlen, max_edit, floats)
    if gaps is not None and gaps.shape != (4,):
        raise ValueError(f"{fn.__name__}: gaps must be [4], got {tuple(gaps.shape)}")
    if hop is not None and hop.shape != (16,):
        raise ValueError(f"{fn.__name__}: hop16 must be [16], got {tuple(hop.shape)}")
    if panels is not None:
        for nm, t, like in zip(("io", "ie", "do", "de"), panels, (read, read, allele, allele)):
            if t.shape != like.shape:
                raise ValueError(f"{fn.__name__}: {nm} must be {tuple(like.shape)}, "
                                 f"got {tuple(t.shape)}")
    if allele.device.type == "cpu":
        return reference()
    if allele.device.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {allele.device}")
    out = _launch(flavour, allele, alen, read, mis, rlen, max_edit, gaps, hop, panels)
    fn.launches += 1
    fn.forwards += allele.shape[0]
    return out


def banded_forward(allele, alen, read, mis, rlen, gaps, max_edit):
    """``_forward_impl``: [B] float32 log forward probabilities.  CPU tensors:
    the plain version.  CUDA tensors: the kernel (counted in
    ``banded_forward.launches``, its items in ``.forwards``)."""
    return _dispatch(
        banded_forward, "banded",
        lambda: banded_forward_reference(allele, alen, read, mis, rlen, gaps, max_edit),
        allele, alen, read, mis, rlen, max_edit, gaps=gaps)


def positional_banded_forward(allele, alen, read, mis, rlen, io, ie, do, de, max_edit):
    """``_forward_hp_impl`` with the LOG gap panels.  CPU tensors: the plain
    version.  CUDA tensors: the kernel (``positional_banded_forward.launches``,
    ``.forwards``)."""
    return _dispatch(
        positional_banded_forward, "positional",
        lambda: positional_banded_forward_reference(allele, alen, read, mis, rlen, io, ie,
                                                    do, de, max_edit),
        allele, alen, read, mis, rlen, max_edit, panels=(io, ie, do, de))


def hop_forward(allele, alen, read, mis, rlen, gaps, hop, max_edit):
    """``_forward_hop_impl`` with the LOG gaps and hop16.  CPU tensors: the
    plain version.  CUDA tensors: the kernel (``hop_forward.launches``,
    ``.forwards``)."""
    return _dispatch(
        hop_forward, "hop",
        lambda: hop_forward_reference(allele, alen, read, mis, rlen, gaps, hop, max_edit),
        allele, alen, read, mis, rlen, max_edit, gaps=gaps, hop=hop)


for _fn in (banded_forward, positional_banded_forward, hop_forward):
    _fn.launches = 0
    _fn.forwards = 0  # work items of those launches


def wavefront_args(alleles, reads, quals, max_dists, gap, device, hop=None,
                   hop_states=False):
    """The inputs of one wavefront flavour for ragged work items, on
    ``device``: (flavour, args) with args in the wrapper's order.  ``hop``
    given: the hop-state flavour with ``hop_states``, else the positional
    flavour; no ``hop``: the banded flavour."""
    allele, alen, read, mis, rlen, medge = pack_wavefront(alleles, reads, quals, max_dists)
    a, al, r, m, rl, me = to_device((allele, alen, read, mis, rlen, medge), device)
    gaps = np.asarray(gap, dtype=np.float32)
    if hop is None:
        return "banded", (a, al, r, m, rl, *to_device((gaps,), device), me)
    if hop_states:
        return "hop", (a, al, r, m, rl, *to_device((gaps, hop16(hop)), device), me)
    panels = to_device(positional_panels(allele, read, gaps, hop), device)
    return "positional", (a, al, r, m, rl, *panels, me)


def reference_of(flavour, args, stats=None):
    """The plain version of ``flavour`` on the wrapper's ``args``, adding
    the cells it computes to ``stats["cells"]`` when given."""
    allele, alen, read, mis, rlen = args[:5]
    if flavour == "banded":
        return _wavefront_reference(allele, alen, read, mis, rlen, args[6], gaps=args[5],
                                    stats=stats)
    if flavour == "positional":
        return _wavefront_reference(allele, alen, read, mis, rlen, args[9],
                                    panels=args[5:9], stats=stats)
    return _wavefront_reference(allele, alen, read, mis, rlen, args[7], gaps=args[5],
                                hop=args[6], stats=stats)


WRAPPERS = {"banded": banded_forward, "positional": positional_banded_forward,
            "hop": hop_forward}


def forward_items(alleles, reads, quals, max_dists, gap, device, hop=None, hop_states=False):
    """Batched wavefront forward log-probs of ragged work items on
    ``device`` (:func:`wavefront_args`); float64 [n]."""
    if len(alleles) == 0:
        return np.zeros(0, dtype=np.float64)
    flavour, args = wavefront_args(alleles, reads, quals, max_dists, gap, device, hop,
                                   hop_states)
    return WRAPPERS[flavour](*args).cpu().numpy().astype(np.float64)
