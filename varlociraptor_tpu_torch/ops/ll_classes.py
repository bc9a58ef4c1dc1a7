"""K1: read-summed class log-likelihoods (hand-written CUDA kernel + plain twin).

    ll[n, u] = sum_d log( w * a[n,d] + (1 - w) * r[n,d] + m[n,d] ),
    w        = clip( psa[n,d] * nu[u] + kappa[u] * (1 - psa[n,d]), 0, 1 )

Counterpart of ``varlociraptor_tpu/ops/pallas_kernels.py`` (``ll_classes_pallas``
and its dispatcher ``ll_classes``).  The kernel is ``csrc/ll_classes.cu``.
Masked reads must be folded by the caller to (a, r, m) = (1, 1, 0); the
per-read scale ``c`` is added by the caller (see :func:`ll_classes_folded`).

A CPU tensor goes to :func:`ll_classes_reference`; a CUDA tensor goes to the
kernel, or the call raises.
"""

from __future__ import annotations

import torch

# rows x classes x reads per chunk of the plain version: bounds its
# [rows, U, D] intermediates (the whole cube is 24 GB at the bench shape)
_REF_CHUNK_CELLS = 1 << 24


def ll_classes_reference(a, r, m, psa, nu, kappa):
    """Plain torch version of the kernel, chunked over rows.  [N, U] f32.

    Like the kernel, it sums the per-read logs in float64 and rounds once."""
    N, D = a.shape
    U = nu.shape[0]
    out = torch.empty((N, U), dtype=torch.float32, device=a.device)
    step = max(1, _REF_CHUNK_CELLS // max(U * max(D, 1), 1))
    nu_ = nu[None, :, None]
    kap_ = kappa[None, :, None]
    for s in range(0, N, step):
        e = min(N, s + step)
        p = psa[s:e, None, :]
        w = torch.clamp(p * nu_ + kap_ * (1.0 - p), 0.0, 1.0)  # [n,U,D]
        t = w * a[s:e, None, :] + (1.0 - w) * r[s:e, None, :] + m[s:e, None, :]
        out[s:e] = torch.log(t).sum(dim=-1, dtype=torch.float64)
    return out


def _check(a, r, m, psa, nu, kappa):
    for name, t in (("a", a), ("r", r), ("m", m), ("psa", psa),
                    ("nu", nu), ("kappa", kappa)):
        if t.dtype != torch.float32:
            raise TypeError(f"ll_classes: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ll_classes: {name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"ll_classes: {name} on {t.device}, a on {a.device}")
    if a.dim() != 2 or any(t.shape != a.shape for t in (r, m, psa)):
        raise ValueError(
            f"ll_classes: a, r, m, psa must share one [N, D] shape, got "
            f"{[tuple(t.shape) for t in (a, r, m, psa)]}"
        )
    if nu.dim() != 1 or kappa.shape != nu.shape:
        raise ValueError(
            f"ll_classes: nu, kappa must be [U], got {tuple(nu.shape)}, "
            f"{tuple(kappa.shape)}"
        )
    N, D = a.shape
    if N * max(nu.shape[0], D) >= 2**62 or max(N, nu.shape[0], D) >= 2**31:
        raise ValueError("ll_classes: sizes exceed the kernel's int32 bounds")


def ll_classes(a, r, m, psa, nu, kappa):
    """[N, U] read-summed log-likelihoods on (nu, kappa) classes.

    a/r/m/psa [N, D] f32 contiguous, masked reads folded to (1, 1, 0);
    nu/kappa [U] f32.  CPU tensors: the plain version.  CUDA tensors: the
    K1 kernel (counted in ``ll_classes.launches``)."""
    _check(a, r, m, psa, nu, kappa)
    if a.device.type == "cpu":
        return ll_classes_reference(a, r, m, psa, nu, kappa)
    if a.device.type != "cuda":
        raise ValueError(f"ll_classes: unsupported device {a.device}")
    from .._build import load

    lib = load()
    N, D = a.shape
    U = nu.shape[0]
    out = torch.empty((N, U), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.vlt_ll_classes(
            a.data_ptr(), r.data_ptr(), m.data_ptr(), psa.data_ptr(),
            nu.data_ptr(), kappa.data_ptr(), out.data_ptr(), N, U, D, stream,
        )
    if err != 0:
        raise RuntimeError(f"ll_classes kernel launch failed: CUDA error {err}")
    ll_classes.launches += 1
    if launch_hook is not None:
        launch_hook(N, U, D)
    return out


ll_classes.launches = 0
# called as launch_hook(N, U, D) after each kernel launch (chip_smoke.py
# records K1's launch shapes on the main path with it)
launch_hook = None


def ll_classes_folded(a, r, m, c, psa, mask, nu, kappa):
    """[L, B, U] class likelihood sums from `_read_terms` outputs.

    a/r/m/c [L, B, D]; psa [L, 1, D]; mask [L, D] bool.  Folds masked reads
    to (1, 1, 0), runs :func:`ll_classes` on the [L*B, D] rows and adds the
    masked per-read scale sum (pallas_kernels.ll_classes, :155-162)."""
    L, B, D = a.shape
    mk = mask[:, None, :]
    c_sum = torch.where(mk, c, 0.0).sum(dim=-1)  # [L,B]
    one = torch.ones((), dtype=a.dtype, device=a.device)
    a_f = torch.where(mk, a, one).reshape(L * B, D).contiguous()
    r_f = torch.where(mk, r, one).reshape(L * B, D).contiguous()
    m_f = torch.where(mk, m, 0.0).reshape(L * B, D).contiguous()
    psa_f = psa.expand(L, B, D).reshape(L * B, D).contiguous()
    ll = ll_classes(a_f, r_f, m_f, psa_f, nu.contiguous(), kappa.contiguous())
    return ll.reshape(L, B, -1) + c_sum[:, :, None]
