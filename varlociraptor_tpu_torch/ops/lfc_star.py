"""The engine's star l2fc integral (hand-written CUDA kernel + plain twin).

    total[l,b] = logsumexp_{g, ga, gb} ( fa[l,b,ga,g] + fb[l,b,gb,g]
                                          + lm[ga,gb] + rp[l,b,g] )

with fa = pa + wa[l, ga] and fb = pb + wb[l, gb]: two samples a and b
contaminated by one root p, their pair planes pa [L, B, Ga, Gp] and pb [L,
B, Gb, Gp] with their branch weights wa [L, Ga] and wb [L, Gb], the l2fc
predicate's log mask lm [Ga, Gb] (0 or -inf) and the root's own terms rp
[L, B, Gp].  Counterpart of the ``lax.scan`` over the parent grid in
``varlociraptor_tpu/ops/posterior.py:PosteriorEngine._run_impl`` (lines
1228-1280), which XLA compiles; the kernel is ``csrc/lfc_star.cu``.

A CPU tensor goes to :func:`lfc_star_reference`; a CUDA tensor goes to the
kernel, or the call raises.
"""

from __future__ import annotations

import torch

from .. import tracing
from .likelihood import NEG_INF, _lse


def lfc_star_reference(pa, wa, pb, wb, lm, rp):
    """[L, B] star integral by a loop over the parent grid, one [L, B, Ga,
    Gb] slab a step."""
    fa = pa + wa[:, None, :, None]  # [L,B,Ga,Gp]
    fb = pb + wb[:, None, :, None]
    total = torch.full(rp.shape[:2], NEG_INF, device=rp.device)
    for g in range(rp.shape[-1]):
        slab = (
            fa[..., g][:, :, :, None] + fb[..., g][:, :, None, :]
            + lm[None, None]
        )
        total = torch.logaddexp(total, _lse(slab, dim=(-2, -1)) + rp[..., g])
    return total


def _check(pa, wa, pb, wb, lm, rp):
    args = {"pa": pa, "wa": wa, "pb": pb, "wb": wb, "lm": lm, "rp": rp}
    for name, x in args.items():
        if x.dtype != torch.float32:
            raise TypeError(f"lfc_star: {name} must be float32, got {x.dtype}")
        rank = {"pa": 4, "pb": 4, "rp": 3}.get(name, 2)
        if x.dim() != rank:
            raise ValueError(f"lfc_star: {name} must have rank {rank}, got {tuple(x.shape)}")
        if x.device != rp.device:
            raise ValueError(f"lfc_star: {name} on {x.device}, rp on {rp.device}")
    L, B, Gp = rp.shape
    Ga, Gb = pa.shape[2], pb.shape[2]
    if (pa.shape != (L, B, Ga, Gp) or pb.shape != (L, B, Gb, Gp) or wa.shape != (L, Ga)
            or wb.shape != (L, Gb) or lm.shape != (Ga, Gb)):
        raise ValueError(
            "lfc_star: shapes pa [L, B, Ga, Gp] {}, wa [L, Ga] {}, pb [L, B, Gb, Gp] {}, "
            "wb [L, Gb] {}, lm [Ga, Gb] {}, rp [L, B, Gp] {} do not agree".format(
                *(tuple(x.shape) for x in args.values())))
    if max(L * B, Gp) >= 2**31 or Ga * Gb * 4 >= 2**31:
        raise ValueError("lfc_star: sizes exceed the kernel's int32 bounds")


def lfc_star(pa, wa, pb, wb, lm, rp):
    """[L, B] star integral of one l2fc branch; the inputs may be strided
    views (``wa`` a column of the branch weights).  CPU tensors: the plain
    version.  CUDA tensors: one launch of the kernel (counted in
    ``lfc_star.launches`` and the trace counter ``engine.lfc_star_launches``)."""
    _check(pa, wa, pb, wb, lm, rp)
    if rp.device.type == "cpu":
        return lfc_star_reference(pa, wa, pb, wb, lm, rp)
    if rp.device.type != "cuda":
        raise ValueError(f"lfc_star: unsupported device {rp.device}")
    from .._build import load

    lib = load()
    L, B, Gp = rp.shape
    out = torch.empty((L, B), dtype=torch.float32, device=rp.device)
    with torch.cuda.device(rp.device):
        stream = torch.cuda.current_stream(rp.device).cuda_stream
        err = lib.vlt_lfc_star(
            pa.data_ptr(), wa.data_ptr(), pb.data_ptr(), wb.data_ptr(), lm.data_ptr(),
            rp.data_ptr(), out.data_ptr(), L, B, pa.shape[2], pb.shape[2], Gp,
            *pa.stride(), *wa.stride(), *pb.stride(), *wb.stride(), *lm.stride(),
            *rp.stride(), stream,
        )
    if err != 0:
        raise RuntimeError(f"lfc_star kernel launch failed: CUDA error {err}")
    lfc_star.launches += 1
    tracing.count("engine.lfc_star_launches", 1)
    return out


lfc_star.launches = 0
