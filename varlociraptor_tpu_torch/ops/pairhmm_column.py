"""K2, K3 and K4: the exact semiglobal pair-HMM forward as a column recurrence.

Counterpart of ``varlociraptor_tpu/ops/pallas_pairhmm.py``.  The kernels are
``csrc/pairhmm_column.cu``; each has a plain torch version here that computes
the same function in the same order of operations.

K2 (``exact_forward``): zero gap extension.  The D and I states then have no
self-recurrence, and the three-state DP collapses to one state and three
terms per cell:

    M(i,j) = e_m(i,j) * [ t_mm * M(i-1,j-1) + t_dm*t_md * M(i-2,j-1)
                          + t_im*t_mi*m_{j-1} * M(i-1,j-2) ]

On the card it runs at a tile (lanes per item, allele rows per lane) that
:func:`exact_tile` picks from the panel width, on the layout of K3 and K4.

K3 (``general_forward``): constant finite extensions, three states M/I/D.
Within a column D(i) = t_md*M(i-1) + t_dd*D(i-1) is a first-order linear
recurrence over i (a prefix scan).  On the card it runs at a tile (lanes
per item, allele rows per lane) that :func:`general_tile` picks from the
panel width.

K4 (``positional_forward``): K3 with per-position gap probabilities, the
homopolymer mode.  The insertion open / extend of read base j (io_j, ie_j)
and the deletion open / extend of allele row k (do_k, de_k) replace the
constants, indexed as ``pallas_pairhmm.py:_general_body`` indexes them:
t_mm = max(1 - io_j - do_k, 1e-12), t_dm = 1 - de_k (unclamped, times
D(k-1) of the previous column), t_im = 1 - ie_j, t_mi = io_j, t_ii = ie_j,
and D(k) = do_k*M(k-1) + de_k*D(k-1).  :func:`positional_gaps` builds the
four LINEAR panels on the device from the packed bytes.  On the card it
runs on the tiled layout of K2 and K3, at the tile :func:`positional_tile`
picks.

All three work in linear-space float32.  A work item whose column maximum falls
below 1e-16 is multiplied by 1e16 (its log scale is kept aside), start and
end are free on the allele axis, and the read is consumed in full.  An empty
read returns -1e30.

Inputs are row-major uint8 panels as the host packs them
(:func:`pack_exact_batch`): allele [B, Xp], read [B, Yp], qual [B, Yp]
(PHRED), alen / rlen [B] int32 (rlen clamped to >= 1), and the coefficient
vector (:func:`exact_coef`, :func:`general_coef`) or, for K4, the gap
panels io / ie [B, Yp] and do / de [B, Xp] float32.  The uppercase fold and
PHRED -> miscall happen on the tensor's device.  A CPU tensor goes to the
plain version; a CUDA tensor goes to the kernel, or the call raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RESCALE_THRESH = 1e-16
RESCALE = 1e16
EMPTY = -1e30  # result of an empty read (and of a read with no alignment)
# largest allele panel the kernels take: 32 warps x 32 lanes x 32 positions
MAX_XP = 32 * 32 * 32
_LN10_10 = math.log(10.0) / 10.0
# the tiles of K2, K3 and K4 up to Xp = 1024, (lanes per item, allele rows
# per lane), as csrc/pairhmm_column.cu:VLT_GENERAL_TILES instantiates them
# for the three kernels; wider panels take the multi-warp kernels, tile
# (32, 32)
GENERAL_TILES = ((8, 4), (8, 8), (8, 12), (8, 16), (16, 6), (16, 8), (16, 10), (16, 12),
                 (16, 16), (32, 5), (32, 6), (32, 8), (32, 12), (32, 16), (32, 24), (32, 32))
# called around every kernel launch when set (see _launch)
launch_hook = None


def general_tile(Xp, max_rows=None, lanes=None):
    """K3's tile (lanes, rows) for an allele panel of Xp rows: of the tiles
    that cover Xp (with at most ``max_rows`` rows and ``lanes`` lanes, if
    given; else of all), the one with the fewest padded rows, then 16
    lanes, then the fewest.  On an H100, 16 lanes beat 8 lanes with twice
    the rows (more warps hide the column chain's latency) and 32 lanes with
    half the rows (the per-column shuffles take log2(lanes) steps) at Xp
    128, 160 and 256 (PERF.md, PR 6).  (32, 32) over 1024 rows."""
    if Xp > 32 * 32:
        return (32, 32)
    fits = [t for t in GENERAL_TILES if t[0] * t[1] >= Xp]
    pick = [t for t in fits if t[1] <= (max_rows or t[1]) and t[0] == (lanes or t[0])]
    return min(pick or fits, key=lambda t: (t[0] * t[1], t[0] != 16, t[0]))


def positional_tile(Xp):
    """K4's tile (lanes, rows) for an allele panel of Xp rows: of the tiles
    that cover Xp, the one with the fewest padded rows, then the fewest
    lanes; (32, 32) over 1024 rows.  It differs from :func:`general_tile`
    at 65-128 rows, where it takes 8 lanes.  K4 holds do / de / 1 - de per
    row on top of K3's registers: on an H100 (PERF.md §6) (16, 8) takes
    113 and (8, 16) 168, so a scheduler's 16K registers keep 4 warps of
    (16, 8), 8 items, or 3 of (8, 16), 12 items.  The main path's 128-row
    launches hold ~4,300 items, past the 4,224 that one wave of (16, 8)
    takes on 132 SMs: (8, 16) takes 11% less time at 4,326 items and 2.5%
    less on the main path's own launches, (16, 8) 6% less at 4,220 items.
    At 160 and 256 rows 16 lanes take 24% and 9% less time than 32."""
    if Xp > 32 * 32:
        return (32, 32)
    return min((t for t in GENERAL_TILES if t[0] * t[1] >= Xp),
               key=lambda t: (t[0] * t[1], t[0]))


def exact_tile(Xp):
    """K2's tile (lanes, rows) for an allele panel of Xp rows: K3's policy,
    :func:`general_tile` (16 lanes where they pad no more; (32, 32) over
    1024 rows).  K2 keeps ~4 registers per row against K3's ~7, so at 128
    rows (16, 8) takes 64 and (8, 16) 95 registers, and one wave holds the
    main path's ~4,400-item launches either way.  On an H100 at 700 W
    (PERF.md §6) (8, 16) took 1.6% less time at 4394 x 128 x 100 and 3.7% more on
    the main path's own launches; (32, 5) took 37% more (25% padded rows,
    5-step group maximum, 33 one-warp blocks per SM where an SM holds 32);
    at 160 and 256 rows 32 lanes took 27% and 22% more than (16, 10) and
    (16, 16)."""
    return general_tile(Xp)


# ---------------------------------------------------------------------------
# host packing (numpy), as pallas_pairhmm.py packs, without the TPU's
# 128-lane tile and power-of-two batch buckets: B is the item count
# ---------------------------------------------------------------------------


def _scatter_rows(items, B, Np):
    """Ragged byte items -> [B, Np] uint8 row-major panel (zero pad), and the
    item lengths.  Each item's bytes land contiguously in its own row."""
    flat = np.concatenate(
        [
            np.frombuffer(x, dtype=np.uint8)
            if isinstance(x, (bytes, bytearray))
            else np.asarray(x, dtype=np.uint8)
            for x in items
        ]
    )
    lens = np.fromiter((len(x) for x in items), dtype=np.int64, count=len(items))
    pos = np.arange(lens.sum()) - np.repeat(
        np.concatenate([[0], np.cumsum(lens[:-1])]), lens
    )
    panel = np.zeros((B, Np), dtype=np.uint8)
    panel.ravel()[np.repeat(np.arange(len(items)) * Np, lens) + pos] = flat
    return panel, lens


def exact_coef(gap):
    """[4] f32 (t_mm, t_dm*t_md, t_im*t_mi, t_mi) of the zero-extension model
    from the LOG gap params (t_mi, t_md, ...): the close probabilities t_dm
    and t_im are exactly 1."""
    g_mi = math.exp(gap[0])
    g_md = math.exp(gap[1])
    t_mm = max(1.0 - g_mi - g_md, 1e-12)
    return np.array([t_mm, g_md, g_mi, g_mi], dtype=np.float32)


def general_coef(gap):
    """[7] f32 (t_mm, t_dm, t_im, t_mi, t_md, t_ii, t_dd) LINEAR, from the
    LOG gap params (t_mi, t_md, t_ii, t_dd)."""
    g_mi, g_md, g_ii, g_dd = (math.exp(g) for g in gap[:4])
    return np.array(
        [
            max(1.0 - g_mi - g_md, 1e-12),  # t_mm
            max(1.0 - g_dd, 1e-12),         # t_dm
            max(1.0 - g_ii, 1e-12),         # t_im
            g_mi,                            # t_mi
            g_md,                            # t_md
            g_ii,                            # t_ii
            g_dd,                            # t_dd
        ],
        dtype=np.float32,
    )


def pack_exact_batch(alleles, reads, quals, gap):
    """Pack ragged work items into row-major uint8 panels.

    Returns ((allele, read, qual, alen, rlen, coef), n, Xp, Yp): Xp and Yp
    are the longest allele and read rounded up to 32 (at least 32); rlen is
    clamped to 1 for an empty read (:func:`mask_empty` fixes its result);
    coef is :func:`exact_coef`."""
    n = len(alleles)
    Xp = max(32, -(-max(len(a) for a in alleles) // 32) * 32)
    Yp = max(32, -(-max(len(r) for r in reads) // 32) * 32)
    allele, alens = _scatter_rows([bytes(a) for a in alleles], n, Xp)
    read, rlens = _scatter_rows(reads, n, Yp)
    qual, _ = _scatter_rows(quals, n, Yp)
    alen = alens.astype(np.int32)
    rlen = np.maximum(rlens, 1).astype(np.int32)
    return (allele, read, qual, alen, rlen, exact_coef(gap)), n, Xp, Yp


_ACGT = b"ACGT"  # the hop params' base order


def _gap_lut(base, hop):
    """[6] f32 LINEAR gap probabilities by class: 0 (padding), the base rate,
    and one per base A, C, G, T inside a homopolymer run: the larger of the
    base rate and the base's hop rate (the base rate where the hop rate is
    not finite).  The maxima are float32 and the exponentials numpy's float32
    ``exp``, as ``pallas_pairhmm.pallas_positional_forward``'s ``_linpanel``
    takes them, so the panels are bit-identical to the TPU route's."""
    b = np.float32(base)
    logs = np.array(
        [b] + [np.maximum(b, np.float32(h)) if math.isfinite(h) else b for h in hop],
        dtype=np.float32,
    )
    lut = np.zeros(6, dtype=np.float32)
    with np.errstate(over="ignore"):
        lut[1:] = np.exp(logs)
    return lut


def positional_gaps(seqs, lens, base_open, base_ext, hop_open, hop_ext):
    """Per-position LINEAR gap open / extend panels of packed sequences, on
    ``seqs``' device.

    seqs: [B, N] uint8 (a packed read or allele panel, raw bytes); lens: [B]
    int32 item lengths; base_open / base_ext: LOG base rates; hop_open /
    hop_ext: LOG rates per base (A, C, G, T).  A position whose byte is an
    uppercase A/C/G/T equal to the byte before it (a homopolymer run's
    continuation) takes that base's rate, any other position inside the item
    the base rate, and the padding 0.  This is
    ``varlociraptor_tpu/ops/pairhmm.py:BatchedPairHMM._positional_gaps`` on
    the raw bytes followed by ``_linpanel``, as the TPU route computes them,
    without a loop over items.  Returns (open, ext), each [B, N] float32."""
    B, N = seqs.shape
    dev = seqs.device
    same = torch.zeros((B, N), dtype=torch.bool, device=dev)
    same[:, 1:] = seqs[:, 1:] == seqs[:, :-1]
    cls = torch.ones((B, N), dtype=torch.int64, device=dev)
    for k, base in enumerate(_ACGT):
        cls = torch.where(same & (seqs == base), k + 2, cls)
    inside = torch.arange(N, device=dev)[None, :] < lens.to(dev)[:, None]
    cls = torch.where(inside, cls, 0)
    lut = torch.from_numpy(
        np.stack([_gap_lut(base_open, hop_open), _gap_lut(base_ext, hop_ext)])
    ).to(dev)
    return lut[0][cls], lut[1][cls]


def mask_empty(res, reads):
    """Set the result of every empty read to -1e30.  The pack clamps an empty
    read to one column of pad (quality 0, miscall 1), which would otherwise
    give a bogus positive log-probability."""
    empty = np.fromiter((len(r) == 0 for r in reads), dtype=bool, count=len(reads))
    if empty.any():
        res[empty] = EMPTY
    return res


# ---------------------------------------------------------------------------
# plain torch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _prepare(allele, read, qual):
    """Uppercase-folded f32 allele / read panels and the LINEAR miscall."""
    a = (allele & 0xDF).to(torch.float32)
    r = (read & 0xDF).to(torch.float32)
    mis = torch.exp(qual.to(torch.float32) * torch.tensor(-_LN10_10, dtype=torch.float32))
    return a, r, mis


def _shift(x, k):
    """x[:, i-k] with zeros shifted in (allele position i-k)."""
    return torch.nn.functional.pad(x[:, : x.shape[1] - k], (k, 0))


def _emission(a, rj, mj, valid):
    e_m = torch.where(
        a == rj,
        1.0 - mj,
        torch.where(rj == float(ord("N")), torch.full_like(mj, 0.25), mj * (1.0 / 3.0)),
    )
    return torch.where(valid, e_m, torch.zeros_like(e_m))


def _finish(fin, scale):
    return torch.where(
        fin > 0.0, torch.log(torch.clamp(fin, min=1e-30)), torch.full_like(fin, EMPTY)
    ) - scale


def exact_forward_reference(allele, read, qual, alen, rlen, coef):
    """Plain torch K2: [B] f32 log forward probabilities (see module doc)."""
    B, Xp = allele.shape
    dev = allele.device
    a, rd, mis = _prepare(allele, read, qual)
    t_mm, c_del, c_ins, t_mi = (coef[k] for k in range(4))
    valid = torch.arange(Xp, device=dev)[None, :] < alen[:, None]
    alen_f = alen.to(torch.float32)[:, None]
    rlen_ = rlen[:, None]
    m1 = mis[:, 0:1]
    mjm1 = torch.zeros((B, Xp), dtype=torch.float32, device=dev)
    mjm2 = torch.zeros_like(mjm1)
    scale = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    mprev = torch.zeros_like(scale)
    out = torch.full((B, 1), EMPTY, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(scale)
    log_rescale = torch.tensor(math.log(RESCALE), dtype=torch.float32, device=dev)
    for j in range(1, int(rlen.max()) + 1 if B else 1):
        rj = rd[:, j - 1 : j]
        mj = mis[:, j - 1 : j]
        e_m = _emission(a, rj, mj, valid)
        prev1, prev2 = mjm1, mjm2
        start_w = torch.exp(-scale) if j == 1 else zero
        start_i = c_ins * m1 * torch.exp(-scale) if j == 2 else zero
        bracket = t_mm * _shift(prev1, 1) + c_del * _shift(prev1, 2) + c_ins * mprev * _shift(prev2, 1)
        col = e_m * (bracket + start_w + start_i)
        colmax = col.max(dim=1, keepdim=True).values
        need = (colmax > 0.0) & (colmax < RESCALE_THRESH)
        f = torch.where(need, RESCALE, 1.0)
        col = col * f
        prev1s = prev1 * f
        scale = scale + torch.where(need, log_rescale, 0.0)
        m_sum = col.sum(dim=1, keepdim=True)
        if j == 1:
            i_sum = mj * t_mi * (alen_f + 1.0) * torch.exp(-scale)
        else:
            i_sum = mj * t_mi * prev1s.sum(dim=1, keepdim=True)
        out = torch.where(rlen_ == j, _finish(m_sum + i_sum, scale), out)
        mjm2, mjm1, mprev = prev1s, col, mj
    return out[:, 0]


def _three_state_reference(allele, read, qual, alen, rlen, coef=None, gaps=None):
    """The column recurrence of ``pallas_pairhmm.py:_general_body``: K3 with
    the [7] constants ``coef``, or K4 with the LINEAR panels ``gaps`` =
    (io, ie, do, de).  The within-column D recurrence is a log-shift
    (Kogge-Stone) scan, with the varying extension carried through it as a
    running product for K4."""
    B, Xp = allele.shape
    dev = allele.device
    a, rd, mis = _prepare(allele, read, qual)
    if gaps is None:
        t_mm, t_dm, t_im, t_mi, t_md, t_ii, t_dd = (coef[k] for k in range(7))
    else:
        io, ie, do, de = gaps
        t_md, t_dd = do, de
        t_dm = 1.0 - de
    valid = torch.arange(Xp, device=dev)[None, :] < alen[:, None]
    validf = valid.to(torch.float32)
    rlen_ = rlen[:, None]
    mprev = torch.zeros((B, Xp), dtype=torch.float32, device=dev)
    iprev = torch.zeros_like(mprev)
    dprev = torch.zeros_like(mprev)
    i0prev = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    scale = torch.zeros_like(i0prev)
    zero = torch.zeros_like(i0prev)
    out = torch.full((B, 1), EMPTY, dtype=torch.float32, device=dev)
    log_rescale = torch.tensor(math.log(RESCALE), dtype=torch.float32, device=dev)
    for j in range(1, int(rlen.max()) + 1 if B else 1):
        rj = rd[:, j - 1 : j]
        mj = mis[:, j - 1 : j]
        e_m = _emission(a, rj, mj, valid)
        if gaps is not None:
            io_j = io[:, j - 1 : j]
            ie_j = ie[:, j - 1 : j]
            t_mm = torch.clamp(1.0 - io_j - do, min=1e-12)
            t_im = 1.0 - ie_j
            t_mi = io_j
            t_ii = ie_j
        startm = torch.exp(-scale) if j == 1 else zero
        ihead = torch.cat([i0prev, iprev[:, : Xp - 1]], dim=1)
        mcol = e_m * (t_mm * _shift(mprev, 1) + t_dm * _shift(dprev, 1) + t_im * ihead + startm)
        start_i = mj * t_mi if j == 1 else zero
        icol = mj * (t_mi * mprev + t_ii * iprev) + start_i * validf
        i0col = mj * t_ii * i0prev + start_i
        colmax = torch.maximum(
            mcol.max(dim=1, keepdim=True).values, icol.max(dim=1, keepdim=True).values
        )
        need = (colmax > 0.0) & (colmax < RESCALE_THRESH)
        f = torch.where(need, RESCALE, 1.0)
        mcol = mcol * f
        icol = icol * f
        i0col = i0col * f
        scale = scale + torch.where(need, log_rescale, 0.0)
        d = t_md * _shift(mcol, 1)
        s, fac = 1, t_dd
        while s < Xp:
            d = d + fac * _shift(d, s)
            fac = fac * fac if gaps is None else fac * _shift(fac, s)
            s *= 2
        fin = mcol.sum(dim=1, keepdim=True) + icol.sum(dim=1, keepdim=True) + i0col
        out = torch.where(rlen_ == j, _finish(fin, scale), out)
        mprev, iprev, dprev, i0prev = mcol, icol, d, i0col
    return out[:, 0]


def general_forward_reference(allele, read, qual, alen, rlen, coef):
    """Plain torch K3: [B] f32 log forward probabilities (see module doc)."""
    return _three_state_reference(allele, read, qual, alen, rlen, coef=coef)


def positional_forward_reference(allele, read, qual, alen, rlen, io, ie, do, de):
    """Plain torch K4: [B] f32 log forward probabilities with the LINEAR
    per-position gap panels io / ie [B, Yp] and do / de [B, Xp] (see module
    doc)."""
    return _three_state_reference(allele, read, qual, alen, rlen, gaps=(io, ie, do, de))


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def _check(name, allele, read, qual, alen, rlen, coef=None, n_coef=None, gaps=None):
    """Raise on what the kernels do not take: dtypes, contiguity, devices,
    shapes; ``coef`` [n_coef] for K2 / K3, ``gaps`` (io, ie, do, de) for K4."""
    specs = [("allele", allele, torch.uint8), ("read", read, torch.uint8),
             ("qual", qual, torch.uint8), ("alen", alen, torch.int32),
             ("rlen", rlen, torch.int32)]
    if coef is not None:
        specs.append(("coef", coef, torch.float32))
    if gaps is not None:
        specs += [(nm, t, torch.float32) for nm, t in zip(("io", "ie", "do", "de"), gaps)]
    for nm, t, dt in specs:
        if t.dtype != dt:
            raise TypeError(f"{name}: {nm} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.device != allele.device:
            raise ValueError(f"{name}: {nm} on {t.device}, allele on {allele.device}")
    if allele.dim() != 2 or read.dim() != 2 or qual.shape != read.shape:
        raise ValueError(
            f"{name}: allele [B, Xp], read and qual [B, Yp] expected, got "
            f"{tuple(allele.shape)}, {tuple(read.shape)}, {tuple(qual.shape)}"
        )
    B = allele.shape[0]
    if read.shape[0] != B or alen.shape != (B,) or rlen.shape != (B,):
        raise ValueError(f"{name}: batch sizes differ")
    if coef is not None and coef.shape != (n_coef,):
        raise ValueError(f"{name}: coef must be [{n_coef}], got {tuple(coef.shape)}")
    if gaps is not None:
        for nm, t, like in zip(("io", "ie", "do", "de"), gaps, (read, read, allele, allele)):
            if t.shape != like.shape:
                raise ValueError(
                    f"{name}: {nm} must be {tuple(like.shape)}, got {tuple(t.shape)}"
                )
    if allele.shape[1] > MAX_XP or read.shape[1] >= 2**31 or B >= 2**31:
        raise ValueError(
            f"{name}: allele panel width {allele.shape[1]} exceeds the kernel's "
            f"bound of {MAX_XP}"
        )


def _launch(fn_name, allele, read, *tensors, tile=()):
    """Launch ``fn_name`` of the kernel library on the current stream with
    the device pointers of (allele, read, *tensors, out), B, Xp, Yp and the
    ints of ``tile``.  When ``launch_hook`` is set it is called as
    ``launch_hook(stage, fn_name, allele, read, tensors, tile)``, with stage
    "enter" on entry and "call" / "return" just before and after the library
    call (a profiler records CUDA events there)."""
    from .._build import load

    hook = launch_hook
    if hook is not None:
        hook("enter", fn_name, allele, read, tensors, tile)
    lib = load()
    B, Xp = allele.shape
    Yp = read.shape[1]
    out = torch.empty(B, dtype=torch.float32, device=allele.device)
    if B == 0:
        return out
    ptrs = [t.data_ptr() for t in (allele, read, *tensors, out)]
    with torch.cuda.device(allele.device):
        stream = torch.cuda.current_stream(allele.device).cuda_stream
        if hook is not None:
            hook("call", fn_name, allele, read, tensors, tile)
        err = getattr(lib, fn_name)(*ptrs, B, Xp, Yp, *tile, stream)
        if hook is not None:
            hook("return", fn_name, allele, read, tensors, tile)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
    return out


def _tile_for(name, Xp, tile, policy):
    """``tile`` (default ``policy(Xp)``) as a tuple, if it takes a panel of
    Xp rows: one of GENERAL_TILES covering Xp, or (32, 32) over 1024 rows."""
    tile = policy(Xp) if tile is None else tuple(tile)
    fits = tile == (32, 32) if Xp > 32 * 32 else tile[0] * tile[1] >= Xp
    if tile not in GENERAL_TILES or not fits:
        raise ValueError(f"{name}: tile {tile} does not take Xp = {Xp}")
    return tile


def exact_forward(allele, read, qual, alen, rlen, coef, tile=None):
    """K2: [B] f32 log forward probabilities, zero-extension model.  CPU
    tensors: the plain version.  CUDA tensors: the kernel at ``tile``
    (lanes, rows), by default :func:`exact_tile` of the panel width
    (counted in ``exact_forward.launches``, its items in ``.forwards``)."""
    _check("exact_forward", allele, read, qual, alen, rlen, coef, 4)
    tile = _tile_for("exact_forward", allele.shape[1], tile, exact_tile)
    if allele.device.type == "cpu":
        return exact_forward_reference(allele, read, qual, alen, rlen, coef)
    if allele.device.type != "cuda":
        raise ValueError(f"exact_forward: unsupported device {allele.device}")
    out = _launch("vlt_pairhmm_exact", allele, read, qual, alen, rlen, coef, tile=tile)
    exact_forward.launches += 1
    exact_forward.forwards += allele.shape[0]
    return out


exact_forward.launches = 0
exact_forward.forwards = 0  # work items of those launches


def general_forward(allele, read, qual, alen, rlen, coef, tile=None):
    """K3: [B] f32 log forward probabilities, constant finite extensions.
    CPU tensors: the plain version.  CUDA tensors: the kernel at ``tile``
    (lanes, rows), by default :func:`general_tile` of the panel width
    (counted in ``general_forward.launches``, its items in ``.forwards``)."""
    _check("general_forward", allele, read, qual, alen, rlen, coef, 7)
    tile = _tile_for("general_forward", allele.shape[1], tile, general_tile)
    if allele.device.type == "cpu":
        return general_forward_reference(allele, read, qual, alen, rlen, coef)
    if allele.device.type != "cuda":
        raise ValueError(f"general_forward: unsupported device {allele.device}")
    out = _launch("vlt_pairhmm_general", allele, read, qual, alen, rlen, coef, tile=tile)
    general_forward.launches += 1
    general_forward.forwards += allele.shape[0]
    return out


general_forward.launches = 0
general_forward.forwards = 0  # work items of those launches


def positional_forward(allele, read, qual, alen, rlen, io, ie, do, de, tile=None):
    """K4: [B] f32 log forward probabilities with per-position gaps (the
    LINEAR panels of :func:`positional_gaps`).  CPU tensors: the plain
    version.  CUDA tensors: the kernel at ``tile`` (lanes, rows), by default
    :func:`positional_tile` of the panel width (counted in
    ``positional_forward.launches``, its items in ``.forwards``)."""
    gaps = (io, ie, do, de)
    _check("positional_forward", allele, read, qual, alen, rlen, gaps=gaps)
    tile = _tile_for("positional_forward", allele.shape[1], tile, positional_tile)
    if allele.device.type == "cpu":
        return positional_forward_reference(allele, read, qual, alen, rlen, *gaps)
    if allele.device.type != "cuda":
        raise ValueError(f"positional_forward: unsupported device {allele.device}")
    out = _launch("vlt_pairhmm_positional", allele, read, qual, alen, rlen, *gaps, tile=tile)
    positional_forward.launches += 1
    positional_forward.forwards += allele.shape[0]
    return out


positional_forward.launches = 0
positional_forward.forwards = 0  # work items of those launches


def to_device(args, device):
    """Host panels (numpy) -> contiguous tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in args)


def positional_args(alleles, reads, quals, gap, hop, device):
    """K4's inputs for ragged work items, on ``device``: the packed panels
    (:func:`pack_exact_batch`) and the gap panels of :func:`positional_gaps`,
    the read side from gap[0] / gap[2] (insertion open / extend) and the hop
    params' ``prob_seq_*``, the allele side from gap[1] / gap[3] (deletion)
    and ``prob_ref_*``.  Returns (allele, read, qual, alen, rlen, io, ie, do,
    de)."""
    (allele, read, qual, alen, rlen, _), n, _, _ = pack_exact_batch(
        alleles, reads, quals, gap
    )
    read_lens = np.fromiter((len(r) for r in reads), dtype=np.int32, count=n)
    a, r, q, al, rl, rlens = to_device((allele, read, qual, alen, rlen, read_lens), device)
    io, ie = positional_gaps(r, rlens, gap[0], gap[2], hop.prob_seq_homopolymer,
                             hop.prob_seq_extend_homopolymer)
    do, de = positional_gaps(a, al, gap[1], gap[3], hop.prob_ref_homopolymer,
                             hop.prob_ref_extend_homopolymer)
    return a, r, q, al, rl, io, ie, do, de


def forward_items(alleles, reads, quals, gap, device, general, hop=None):
    """Batched forward log-probs of ragged work items on ``device``: K4 when
    ``hop`` (the homopolymer hop params) is given (:func:`positional_args`),
    else packed on the host and K2 (``general=False``) or K3; results back
    as float64 [n] with empty reads masked to -1e30."""
    if len(alleles) == 0:
        return np.zeros(0, dtype=np.float64)
    if hop is not None:
        out = positional_forward(*positional_args(alleles, reads, quals, gap, hop, device))
    else:
        (allele, read, qual, alen, rlen, coef), _, _, _ = pack_exact_batch(
            alleles, reads, quals, gap
        )
        if general:
            coef = general_coef(gap)
        fn = general_forward if general else exact_forward
        out = fn(*to_device((allele, read, qual, alen, rlen, coef), device))
    return mask_empty(out.cpu().numpy().astype(np.float64), reads)
