"""The engine's grid contraction (hand-written CUDA kernel + plain twin).

    out[l,b,n,u] = logsumexp_v ( F[l,b,v,u] + S[l,b,n,v] ),  v in class(n)

with the shifts of :func:`lse_contract_reference`: mS, the max of S over all
v, and mF, the max of F over the v of branch n's spectrum-support class,
each 0 where it is not finite; a branch in no class gets 0.  Counterpart of
``varlociraptor_tpu/ops/posterior.py:PosteriorEngine._lse_contract``, which
XLA compiles; the kernel is ``csrc/lse_contract.cu``.

A CPU tensor goes to :func:`lse_contract_reference`; a CUDA tensor goes to
the kernel, or the call raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from .likelihood import NEG_INF

# branches per group of the kernel's class table (GROUP in the source)
GROUP = 8


class ClassTable(NamedTuple):
    """One sample's spectrum-support classes on the engine's device.

    ``per``: [(branch index [n_k] int64, mask [Gv] bool)] of each class with
    branches, for the plain version; ``branch_class`` [NB] int32 (-1: no
    class), the table as given, kept on the host for the checks; ``masks``
    [K, Gv] uint8 and ``groups`` [G, 2 + GROUP] int32, the kernel's: up to
    GROUP branches of one class a row (class or -1, count, branches, -1
    padded)."""

    per: list
    branch_class: np.ndarray
    masks: torch.Tensor
    groups: torch.Tensor


def class_table(branch_class, masks, device) -> ClassTable:
    """The :class:`ClassTable` of ``branch_class`` [NB] and ``masks`` [K, Gv]."""
    cls = np.asarray(branch_class, dtype=np.int64)
    masks = np.asarray(masks, dtype=bool)
    if cls.ndim != 1 or masks.ndim != 2 or cls.max(initial=-1) >= masks.shape[0]:
        raise ValueError(
            f"class_table: branch_class [NB] must name rows of masks [K, Gv], got "
            f"{cls.shape} with max {cls.max(initial=-1)}, masks {masks.shape}"
        )

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)

    per, rows = [], []
    for k in [*range(masks.shape[0]), -1]:
        idx = np.nonzero(cls == k)[0] if k >= 0 else np.nonzero(cls < 0)[0]
        if len(idx) and k >= 0:
            per.append((t(idx.astype(np.int64)), t(masks[k])))
        for s in range(0, len(idx), GROUP):
            part = idx[s:s + GROUP]
            rows.append([k, len(part), *part, *[-1] * (GROUP - len(part))])
    return ClassTable(per, cls.astype(np.int32), t(masks.astype(np.uint8)),
                      t(np.asarray(rows, dtype=np.int32).reshape(-1, 2 + GROUP)))


def lse_contract_reference(F, S, classes):
    """logsumexp over v of F[l,b,v,u] + S[l,b,n,v] -> [l,b,n,u].

    Shifted-exp einsum: shifts are taken per spectrum-support class of
    the eliminated sample.  classes: [(branch index tensor, mask [Gv])]."""
    L, B = F.shape[0], F.shape[1]
    Gu = F.shape[3]
    mS = torch.amax(S, dim=-1)  # [L,B,NB]
    mS_s = torch.where(torch.isfinite(mS), mS, 0.0)
    Q = torch.exp(S - mS_s[..., None])  # [L,B,NB,Gv]
    out = torch.zeros((L, B, S.shape[2], Gu), dtype=F.dtype, device=F.device)
    for idx, cmask in classes:
        cm = cmask[None, None, :, None]
        Fk = torch.where(cm, F, NEG_INF)
        mF = torch.amax(Fk, dim=2)  # [L,B,Gu]
        mF_s = torch.where(torch.isfinite(mF), mF, 0.0)
        P = torch.where(cm, torch.exp(Fk - mF_s[:, :, None, :]), 0.0)
        Qk = Q[:, :, idx, :]
        R = torch.einsum("lbvu,lbnv->lbnu", P, Qk)
        vals = torch.log(R) + mF_s[:, :, None, :] + mS_s[:, :, idx, None]
        out[:, :, idx, :] = vals
    return out


def _check(F, S, table):
    for name, x in (("F", F), ("S", S)):
        if x.dtype != torch.float32:
            raise TypeError(f"lse_contract: {name} must be float32, got {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"lse_contract: {name} must have rank 4, got {tuple(x.shape)}")
    L, B, Gv, Gu = F.shape
    if S.shape[:2] != (L, B) or S.shape[3] != Gv:
        raise ValueError(
            f"lse_contract: shapes F [L, B, Gv, Gu] {tuple(F.shape)} and "
            f"S [L, B, NB, Gv] {tuple(S.shape)} do not agree"
        )
    NB = S.shape[2]
    if (table.branch_class.shape != (NB,) or table.masks.dim() != 2
            or table.masks.shape[1] != Gv or table.groups.dim() != 2
            or table.masks.shape[0] == 0 or table.groups.shape[1] != 2 + GROUP
            or table.groups.shape[0] == 0):
        raise ValueError(
            f"lse_contract: class table (branch_class {tuple(table.branch_class.shape)}, "
            f"masks {tuple(table.masks.shape)}, groups {tuple(table.groups.shape)}) "
            f"does not fit NB {NB}, Gv {Gv}"
        )
    for name, x in (("S", S), ("masks", table.masks), ("groups", table.groups)):
        if x.device != F.device:
            raise ValueError(f"lse_contract: {name} on {x.device}, F on {F.device}")
    if max(L * B, Gv, Gu, NB) >= 2**31:
        raise ValueError("lse_contract: sizes exceed the kernel's int32 bounds")


def lse_contract(F, S, table):
    """[L, B, NB, Gu] contraction of F [L, B, Gv, Gu] with S [L, B, NB, Gv]
    over the classes of ``table`` (:func:`class_table`).  F and S may be
    strided views (a swapped F, an S expanded over B).  CPU tensors: the
    plain version.  CUDA tensors: one launch of the kernel (counted in
    ``lse_contract.launches`` and the trace counter ``engine.contractions``)."""
    _check(F, S, table)
    if F.device.type == "cpu":
        return lse_contract_reference(F, S, table.per)
    if F.device.type != "cuda":
        raise ValueError(f"lse_contract: unsupported device {F.device}")
    from .._build import load

    lib = load()
    L, B, Gv, Gu = F.shape
    NB = S.shape[2]
    out = torch.empty((L, B, NB, Gu), dtype=torch.float32, device=F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.vlt_lse_contract(
            F.data_ptr(), S.data_ptr(), table.groups.data_ptr(),
            table.masks.data_ptr(), out.data_ptr(), L, B, Gv, Gu, NB,
            table.masks.shape[0], table.groups.shape[0], GROUP, *F.stride(),
            *S.stride(), stream,
        )
    if err != 0:
        raise RuntimeError(f"lse_contract kernel launch failed: CUDA error {err}")
    lse_contract.launches += 1
    tracing.count("engine.contractions", 1)
    return out


lse_contract.launches = 0
