"""The engine's star l2fc integral on the CPU (ops/lfc_star.py): its plain
version is the engine's loop over the parent grid as it was, bit for bit;
the engine's outputs on the l2fc scenario are bit for bit those of the
engine before the kernel; the plain version agrees with a float64
logsumexp taken directly on ragged shapes (Ga != Gb, a one-point parent
grid, a fully masked branch, -inf rows); the wrapper refuses what the kernel
does not take; and a CPU engine goes to the plain version, never the kernel.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from varlociraptor_tpu_torch.bench_utils import (
    L2FC_SCENARIO,
    engine_inputs,
    lfc_star_args,
    scenario_engine,
)
from varlociraptor_tpu_torch.ops import lfc_star as ls
from varlociraptor_tpu_torch.ops import posterior
from varlociraptor_tpu_torch.ops.likelihood import NEG_INF, _lse

# the cases at a CPU test's size (L loci)
SMALL = {"cell": 2, "ragged": 16, "gp1": 16, "masked": 8, "neg_inf": 16, "redo": 8}
# the kernel's numeric contract, which the plain version meets against float64
TOL_REL, TOL_ABS = 2e-6, 1e-4


def _loop_as_it_was(pa, wa, pb, wb, lm, rp):
    """The star route's loop in PosteriorEngine._lfc_group_term before the
    kernel, verbatim (less its step count)."""
    fa = pa + wa[:, None, :, None]  # [L,B,Ga,Gp]
    fb = pb + wb[:, None, :, None]
    L, B = rp.shape[0], rp.shape[1]
    total = torch.full((L, B), NEG_INF, device=rp.device)
    for g in range(rp.shape[-1]):
        slab = (
            fa[..., g][:, :, :, None] + fb[..., g][:, :, None, :]
            + lm[None, None]
        )
        total = torch.logaddexp(total, _lse(slab, dim=(-2, -1)) + rp[..., g])
    return total


def _group_term_as_it_was(self, group, loglik, pair_logliks, w_list, bi,
                          comp_of_sample):
    """PosteriorEngine._lfc_group_term before the kernel, verbatim."""
    nodes = sorted({s for (a, b, _) in group for s in (a, b)})
    if len(group) > 1:
        acyclic = len(group) == len(nodes) - 1
        if acyclic and all(s in self.singletons for s in nodes):
            return self._lfc_tree_eliminate(group, nodes, loglik, w_list, bi)
        return self._lfc_group_joint(
            group, nodes, loglik, pair_logliks, w_list, bi, comp_of_sample
        )
    a, b, lm = group[0]
    za, zb = self.zero_s[a], self.zero_s[b]
    if a in self.singletons and b in self.singletons:
        da = loglik[a] + w_list[a][:, bi][:, None, :]  # [L,B,Ga]
        db = loglik[b] + w_list[b][:, bi][:, None, :]
        joint_ab = da[:, :, :, None] + db[:, :, None, :] + lm[None, None]
        self._lfc_count(joint_ab.numel(), da.numel() + db.numel() + lm.numel(),
                        da.shape[0] * da.shape[1])
        z00 = da[:, :, za] + db[:, :, zb] + lm[za, zb]
        return _lse(joint_ab, dim=(-2, -1)), z00
    p = self.parent[a]
    if (
        p is None
        or self.parent[b] != p
        or self.parent[p] is not None
        or comp_of_sample[a] != comp_of_sample[b]
    ):
        return self._lfc_group_joint(
            group, nodes, loglik, pair_logliks, w_list, bi, comp_of_sample
        )
    zp = self.zero_s[p]
    fa = pair_logliks[a] + w_list[a][:, bi][:, None, :, None]  # [L,B,Ga,Gp]
    fb = pair_logliks[b] + w_list[b][:, bi][:, None, :, None]
    rp = loglik[p] + w_list[p][:, bi][:, None, :]  # [L,B,Gp]
    L, B = rp.shape[0], rp.shape[1]
    cells = L * B * lm.numel() * rp.shape[-1]  # the (a, b, p) joint grid
    inputs = fa.numel() + fb.numel() + rp.numel() + lm.numel()
    rp_zero = rp[..., zp]
    for c in comp_of_sample[a]:
        if c in (a, b, p):
            continue
        fc = pair_logliks[c] + w_list[c][:, bi][:, None, :, None]
        cells, inputs = cells + fc.numel(), inputs + fc.numel()
        rp = rp + _lse(fc, dim=-2)
        rp_zero = rp_zero + fc[..., self.zero_s[c], zp]
    self._lfc_count(cells, inputs, L * B)
    total = torch.full((L, B), NEG_INF, device=rp.device)
    for g in range(rp.shape[-1]):
        self.loop_steps += 1
        slab = (
            fa[..., g][:, :, :, None] + fb[..., g][:, :, None, :]
            + lm[None, None]
        )
        total = torch.logaddexp(total, _lse(slab, dim=(-2, -1)) + rp[..., g])
    z00 = fa[..., za, zp] + fb[..., zb, zp] + lm[za, zb] + rp_zero
    return total, z00


def _bits(x):
    return x.contiguous().view(torch.int32)


def _float64(pa, wa, pb, wb, lm, rp):
    """The integral as one float64 logsumexp over (g, ga, gb)."""
    fa = pa.double() + wa.double()[:, None, :, None]
    fb = pb.double() + wb.double()[:, None, :, None]
    joint = (fa[:, :, :, None, :] + fb[:, :, None, :, :] + lm.double()[None, None, :, :, None]
             + rp.double()[:, :, None, None, :])
    return torch.logsumexp(joint.flatten(2), dim=-1)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_is_the_loop_as_it_was(name):
    args = lfc_star_args(name, "cpu", L=SMALL[name], seed=1)
    assert torch.equal(_bits(ls.lfc_star_reference(*args)), _bits(_loop_as_it_was(*args)))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_agrees_with_float64(name):
    args = lfc_star_args(name, "cpu", L=SMALL[name], seed=2)
    got, want = ls.lfc_star(*args), _float64(*args)
    fin = torch.isfinite(want)
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin].float())
    if name in ("masked", "neg_inf"):
        assert not fin.all() and (name == "neg_inf") == bool(fin.any())
    err = (got.double()[fin] - want[fin]).abs()
    assert (err <= torch.clamp(TOL_REL * want[fin].abs(), min=TOL_ABS)).all(), err.max()


def test_engine_is_bit_for_bit_as_it_was(monkeypatch):
    """The l2fc scenario (tumor and relapse contaminated by normal): every
    output and the loop's step count as before the kernel."""
    _, engine = scenario_engine(L2FC_SCENARIO, 0.05, "cpu", all_uniform_prior=False)
    inputs = engine_inputs(engine, n_loci=4, depth=16, seed=3)
    n0, engine.loop_steps = ls.lfc_star.launches, 0
    got = engine.run(*inputs)
    steps = engine.loop_steps
    assert ls.lfc_star.launches == n0  # the CPU takes the plain version
    monkeypatch.setattr(posterior.PosteriorEngine, "_lfc_group_term", _group_term_as_it_was)
    engine.loop_steps = 0
    want = engine.run(*inputs)
    assert steps == engine.loop_steps == len(engine._lfc_t) * len(engine.values_s[0])
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_wrapper_checks_its_inputs():
    args = lfc_star_args("ragged", "cpu", L=4)
    pa, wa, pb, wb, lm, rp = args
    n0 = ls.lfc_star.launches
    with pytest.raises(TypeError, match="float32"):
        ls.lfc_star(pa.double(), wa, pb, wb, lm, rp)
    with pytest.raises(ValueError, match="rank"):
        ls.lfc_star(pa, wa, pb, wb, lm, rp[0])
    with pytest.raises(ValueError, match="do not agree"):
        ls.lfc_star(pa, wa, pb, wb, lm.T, rp)
    with pytest.raises(ValueError, match="do not agree"):
        ls.lfc_star(pa, wa, pb[..., :-1], wb, lm, rp)
    with pytest.raises(ValueError, match="on meta"):
        ls.lfc_star(pa, wa, pb, wb, lm.to("meta"), rp)
    with pytest.raises(ValueError, match="unsupported device"):
        ls.lfc_star(*(x.to("meta") for x in args))
    assert ls.lfc_star.launches == n0
