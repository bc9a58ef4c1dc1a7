"""K2 and K3: the exact semiglobal pair-HMM forward as a column recurrence.

Counterpart of ``varlociraptor_tpu/ops/pallas_pairhmm.py``.  The kernels are
``csrc/pairhmm_column.cu``; each has a plain torch version here that computes
the same function in the same order of operations.

K2 (``exact_forward``): zero gap extension.  The D and I states then have no
self-recurrence, and the three-state DP collapses to one state and three
terms per cell:

    M(i,j) = e_m(i,j) * [ t_mm * M(i-1,j-1) + t_dm*t_md * M(i-2,j-1)
                          + t_im*t_mi*m_{j-1} * M(i-1,j-2) ]

K3 (``general_forward``): constant finite extensions, three states M/I/D.
Within a column D(i) = t_md*M(i-1) + t_dd*D(i-1) is a first-order linear
recurrence over i (a prefix scan).

Both work in linear-space float32.  A work item whose column maximum falls
below 1e-16 is multiplied by 1e16 (its log scale is kept aside), start and
end are free on the allele axis, and the read is consumed in full.  An empty
read returns -1e30.

Inputs are row-major uint8 panels as the host packs them
(:func:`pack_exact_batch`): allele [B, Xp], read [B, Yp], qual [B, Yp]
(PHRED), alen / rlen [B] int32 (rlen clamped to >= 1), and the coefficient
vector (:func:`exact_coef`, :func:`general_coef`).  The uppercase fold and
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


def general_forward_reference(allele, read, qual, alen, rlen, coef):
    """Plain torch K3: [B] f32 log forward probabilities (see module doc).
    The within-column D recurrence is a log-shift (Kogge-Stone) scan."""
    B, Xp = allele.shape
    dev = allele.device
    a, rd, mis = _prepare(allele, read, qual)
    t_mm, t_dm, t_im, t_mi, t_md, t_ii, t_dd = (coef[k] for k in range(7))
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
            fac = fac * fac
            s *= 2
        fin = mcol.sum(dim=1, keepdim=True) + icol.sum(dim=1, keepdim=True) + i0col
        out = torch.where(rlen_ == j, _finish(fin, scale), out)
        mprev, iprev, dprev, i0prev = mcol, icol, d, i0col
    return out[:, 0]


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def _check(allele, read, qual, alen, rlen, coef, n_coef, name):
    for nm, t, dt in (("allele", allele, torch.uint8), ("read", read, torch.uint8),
                      ("qual", qual, torch.uint8), ("alen", alen, torch.int32),
                      ("rlen", rlen, torch.int32), ("coef", coef, torch.float32)):
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
    if coef.shape != (n_coef,):
        raise ValueError(f"{name}: coef must be [{n_coef}], got {tuple(coef.shape)}")
    if allele.shape[1] > MAX_XP or read.shape[1] >= 2**31 or B >= 2**31:
        raise ValueError(
            f"{name}: allele panel width {allele.shape[1]} exceeds the kernel's "
            f"bound of {MAX_XP}"
        )


def _launch(fn_name, allele, read, qual, alen, rlen, coef):
    from .._build import load

    lib = load()
    B, Xp = allele.shape
    Yp = read.shape[1]
    out = torch.empty(B, dtype=torch.float32, device=allele.device)
    if B == 0:
        return out
    with torch.cuda.device(allele.device):
        stream = torch.cuda.current_stream(allele.device).cuda_stream
        err = getattr(lib, fn_name)(
            allele.data_ptr(), read.data_ptr(), qual.data_ptr(), alen.data_ptr(),
            rlen.data_ptr(), coef.data_ptr(), out.data_ptr(), B, Xp, Yp, stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
    return out


def exact_forward(allele, read, qual, alen, rlen, coef):
    """K2: [B] f32 log forward probabilities, zero-extension model.  CPU
    tensors: the plain version.  CUDA tensors: the kernel (counted in
    ``exact_forward.launches``)."""
    _check(allele, read, qual, alen, rlen, coef, 4, "exact_forward")
    if allele.device.type == "cpu":
        return exact_forward_reference(allele, read, qual, alen, rlen, coef)
    if allele.device.type != "cuda":
        raise ValueError(f"exact_forward: unsupported device {allele.device}")
    out = _launch("vlt_pairhmm_exact", allele, read, qual, alen, rlen, coef)
    exact_forward.launches += 1
    return out


exact_forward.launches = 0


def general_forward(allele, read, qual, alen, rlen, coef):
    """K3: [B] f32 log forward probabilities, constant finite extensions.
    CPU tensors: the plain version.  CUDA tensors: the kernel (counted in
    ``general_forward.launches``)."""
    _check(allele, read, qual, alen, rlen, coef, 7, "general_forward")
    if allele.device.type == "cpu":
        return general_forward_reference(allele, read, qual, alen, rlen, coef)
    if allele.device.type != "cuda":
        raise ValueError(f"general_forward: unsupported device {allele.device}")
    out = _launch("vlt_pairhmm_general", allele, read, qual, alen, rlen, coef)
    general_forward.launches += 1
    return out


general_forward.launches = 0


def to_device(args, device):
    """Host panels (numpy) -> contiguous tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in args)


def forward_items(alleles, reads, quals, gap, device, general):
    """Batched forward log-probs of ragged work items on ``device``:
    pack on the host, K2 (``general=False``) or K3 on the device, results
    back as float64 [n] with empty reads masked to -1e30."""
    if len(alleles) == 0:
        return np.zeros(0, dtype=np.float64)
    (allele, read, qual, alen, rlen, coef), n, _, _ = pack_exact_batch(
        alleles, reads, quals, gap
    )
    if general:
        coef = general_coef(gap)
    fn = general_forward if general else exact_forward
    out = fn(*to_device((allele, read, qual, alen, rlen, coef), device))
    return mask_empty(out.cpu().numpy().astype(np.float64), reads)
