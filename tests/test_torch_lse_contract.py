"""The engine's grid contraction on the CPU (ops/lse_contract.py): its plain
version is the engine's contraction as it was, bit for bit; it agrees with a
float64 logsumexp taken directly; the wrapper refuses what the kernel does
not take; and a CPU engine goes to the plain version, never the kernel."""

import numpy as np
import pytest
import torch

from varlociraptor_tpu_torch.bench_utils import (
    LSE_CONTRACT_CASES,
    engine_inputs,
    lse_contract_args,
    tumor_normal_engine,
)
from varlociraptor_tpu_torch.ops import lse_contract as lc
from varlociraptor_tpu_torch.ops.likelihood import NEG_INF

# the call's shapes at fewer loci: the three kinds of call a window makes
CELL_CASES = ("unit", "map", "afd_swapped")


@pytest.fixture(scope="module", autouse=True)
def _first_contraction():
    """The first einsum of a process can round otherwise than every later
    one (seen after other test files ran in the process: about an eighth of
    the elements a few ulp apart), which no code here decides; one small
    contraction runs first so that the bit-for-bit tests compare like with
    like."""
    F, S, table = lse_contract_args("unit", "cpu", L=8)
    lc.lse_contract_reference(F, S, table.per)


def _contract_as_it_was(F, S, classes):
    """PosteriorEngine._lse_contract's body before the kernel, verbatim."""
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


def _classes_as_they_were(cls, masks):
    """The class list PosteriorEngine._to_device built before the kernel."""
    per = []
    for k in range(masks.shape[0]):
        idx = np.nonzero(cls == k)[0]
        if len(idx):
            per.append((torch.as_tensor(idx.astype(np.int64)), torch.as_tensor(masks[k])))
    return per


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", CELL_CASES)
def test_reference_is_the_contraction_as_it_was(name):
    F, S, table = lse_contract_args(name, "cpu", L=128, seed=1)
    old = _classes_as_they_were(table.branch_class, table.masks.numpy().astype(bool))
    assert torch.equal(_bits(lc.lse_contract_reference(F, S, table.per)),
                       _bits(_contract_as_it_was(F, S, old)))


def test_engine_contraction_is_bit_for_bit_as_it_was():
    """The engine's own class tables and grid sizes: the tumor grid (101
    points) eliminated into the normal's (15), as in the call."""
    _, engine = tumor_normal_engine(resolution=0.01, device="cpu")
    rng = np.random.default_rng(4)
    (ti, ni) = (0, 1) if engine.parent[0] is not None else (1, 0)
    Gv, Gu, NB = len(engine.values_s[ti]), len(engine.values_s[ni]), engine.n_branches
    cls, masks = engine.support_classes[ti]
    w = rng.normal(-5.0, 2.0, (64, 1, NB, Gv)).astype(np.float32)
    for n in range(NB):
        w[:, :, n, ~masks[cls[n]]] = -np.inf
    F = torch.as_tensor(rng.normal(-20.0, 4.0, (64, 4, Gv, Gu)).astype(np.float32))
    S = torch.as_tensor(w).expand(64, 4, NB, Gv)
    got = engine._lse_contract(F, S, engine._support_t[ti])
    want = _contract_as_it_was(F, S, _classes_as_they_were(cls, masks))
    assert torch.equal(_bits(got), _bits(want))


def _direct_lse64(F, S, table):
    """out[l,b,n,u] = log sum_{v in class(n)} exp(F[l,b,v,u] + S[l,b,n,v]) in
    float64, 0 for a branch in no class."""
    F64, S64 = F.double(), S.double()
    cls = table.branch_class
    masks = table.masks.numpy().astype(bool)
    L, B, _, Gu = F.shape
    out = torch.zeros((L, B, S.shape[2], Gu), dtype=torch.float64)
    for n, k in enumerate(cls):
        if k < 0:
            continue
        v = torch.as_tensor(np.nonzero(masks[k])[0])
        out[:, :, n] = torch.logsumexp(F64[:, :, v, :] + S64[:, :, n, v][..., None], dim=2)
    return out


@pytest.mark.parametrize("name", LSE_CONTRACT_CASES)
def test_reference_matches_a_float64_logsumexp(name):
    """Within 1e-5 * max(1, |x|) where finite, and -inf in the same places:
    the cases' terms lie within ~exp(-40) of their class's largest, so none
    underflows in float32 (the -inf entries are exact zeros)."""
    F, S, table = lse_contract_args(name, "cpu", L=8, seed=2)
    got = lc.lse_contract(F, S, table).double().numpy()
    want = _direct_lse64(F, S, table).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    if name == "neg_inf":
        assert not fin.all()
    if name == "no_class":
        assert (got[:, :, [1, 4]] == 0.0).all()
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.max(initial=0.0) <= 1e-5, err.max()


def _bad_inputs():
    F, S, table = lse_contract_args("no_class", "cpu", L=4)
    _, _, other = lse_contract_args("nb_gt_k", "cpu", L=4)
    meta = table._replace(groups=table.groups.to("meta"))
    return {
        "float64 F": (TypeError, "float32", (F.double(), S, table)),
        "float64 S": (TypeError, "float32", (F, S.double(), table)),
        "rank 3 F": (ValueError, "rank 4", (F[0], S, table)),
        "rank 5 S": (ValueError, "rank 4", (F, S[None], table)),
        "Gv": (ValueError, "do not agree", (F, S[..., :-1], table)),
        "loci": (ValueError, "do not agree", (F, S[:-1], table)),
        "B": (ValueError, "do not agree", (F, S[:, :1], table)),
        "NB": (ValueError, "class table", (F, S, other)),
        "groups width": (ValueError, "class table",
                         (F, S, table._replace(groups=table.groups[:, :-1]))),
        "masks Gv": (ValueError, "class table",
                     (F, S, table._replace(masks=table.masks[:, :-1]))),
        "device": (ValueError, "groups on meta", (F, S, meta)),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses_bad_inputs(case):
    err, match, args = _bad_inputs()[case]
    n0 = lc.lse_contract.launches
    with pytest.raises(err, match=match):
        lc.lse_contract(*args)
    assert lc.lse_contract.launches == n0


def test_class_table_refuses_a_class_without_a_mask():
    with pytest.raises(ValueError, match="rows of masks"):
        lc.class_table(np.array([0, 2]), np.ones((2, 5), bool), "cpu")


def test_class_table_groups():
    """Groups of at most GROUP branches of one class; branches in no class
    in groups of class -1."""
    cls = np.array([1] * 10 + [-1, 0])
    masks = np.zeros((2, 7), bool)
    masks[0, [2, 5]] = True
    masks[1, 3] = True
    t = lc.class_table(cls, masks, "cpu")
    assert t.groups.tolist() == [
        [0, 1, 11] + [-1] * 7,
        [1, 8, *range(8)],
        [1, 2, 8, 9] + [-1] * 6,
        [-1, 1, 10] + [-1] * 7,
    ]
    assert [i.tolist() for i, _ in t.per] == [[11], list(range(10))]
    assert t.branch_class.dtype == np.int32 and t.masks.dtype == torch.uint8


def test_cpu_engine_runs_the_plain_version(monkeypatch):
    """A CPU engine's run takes the plain version for each of the call's
    four contractions and launches nothing."""
    seen = []
    plain = lc.lse_contract_reference

    def spy(F, S, classes):
        seen.append((tuple(F.shape), tuple(S.shape)))
        return plain(F, S, classes)

    monkeypatch.setattr(lc, "lse_contract_reference", spy)
    _, engine = tumor_normal_engine(resolution=0.01, device="cpu")
    n0 = lc.lse_contract.launches
    engine.run(*engine_inputs(engine, n_loci=8, depth=16, seed=3))
    assert lc.lse_contract.launches == n0
    assert len(seen) == 4
    assert seen[0] == ((8, 4, 101, 15), (8, 4, 9, 101))
