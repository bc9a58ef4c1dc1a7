"""The port's pair-HMM (K2, K3, K4 and their dispatcher) against the JAX package.

The port's plain K2 / K3 / K4 (``ops/pairhmm_column.py``) run on the CPU
against

* the JAX Pallas kernels ``pallas_exact_forward`` / ``pallas_general_forward``
  / ``pallas_positional_forward`` in interpret mode (the function the JAX
  package computes on the TPU), and
* the JAX log-space wavefronts ``_forward_impl`` / ``_forward_hp_impl`` with
  the band off, independent evaluations of the same models,

at 5e-4 relative (tests/test_pallas_pairhmm.py:82-83); an empty read gives
exactly -1e30.  Where the float32 linear-space column recurrence underflows
(a read that must insert 30 bases into a 40-base allele without gap
extension: e^-755), the port and the Pallas kernel both give -1e30 and the
log-space wavefront a finite value below e^-300.  Inputs: the ragged ``_synth`` sets, N and lowercase bases, a
read longer than its allele, 250-base reads at quality 2-10 (the 1e16
rescale fires), the 50-base deletion chain, and alleles over 1024 bases.
K4's gap panels (``positional_gaps``) are bit-identical to the ones the JAX
package's TPU route builds (``_positional_gaps`` on the raw bytes, then
``_linpanel``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import varlociraptor_tpu.ops.pallas_pairhmm as jpp
from varlociraptor_tpu.estimation.alignment_properties import GapParams as JaxGapParams
from varlociraptor_tpu.estimation.alignment_properties import HopParams as JaxHopParams
from varlociraptor_tpu.ops.pairhmm import BatchedPairHMM as JaxPairHMM
from varlociraptor_tpu.ops.pairhmm import NEG_INF, _forward_hp_impl, _forward_impl
from varlociraptor_tpu_torch.bench_utils import (
    pairhmm_edge_items,
    pairhmm_items,
    pairhmm_shape_items,
    pairhmm_tile_items,
)
from varlociraptor_tpu_torch.convert import pairhmm_from_jax
from varlociraptor_tpu_torch.estimation.alignment_properties import GapParams, HopParams
from varlociraptor_tpu_torch.ops import pairhmm_column as phc
from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf
from varlociraptor_tpu_torch.ops.pairhmm import BatchedPairHMM

TOL = 5e-4
GAP = np.array([math.log(2.8e-6), math.log(5.1e-6), NEG_INF, NEG_INF], np.float32)
GAP_ONT = np.log(np.array([5.1e-3, 4.2e-3, 0.35, 0.42])).astype(np.float32)
DEFAULT_GAPS = GapParams()
ONT_GAPS = GapParams(*(float(g) for g in GAP_ONT))
LN_005 = math.log(0.05)
# the estimator's shape (open == extend), and one with -inf and small entries
HOP = HopParams(*([[LN_005] * 4] * 4))
HOP_MIXED = HopParams([LN_005, -math.inf, -20.0, -3.0], [-2.5, LN_005, -math.inf, -9.0],
                      [-1.0, -math.inf, -0.5, -30.0], [-math.inf, -1.2, -0.7, -0.1])


@pytest.fixture(autouse=True)
def _default_routes(monkeypatch):
    """The routes these tests hold: tests/test_hop_pairhmm.py sets
    VLT_HOP_STATES=1 when it is imported (every xdist worker imports it),
    and the port's dispatcher reads it."""
    monkeypatch.setenv("VLT_HOP_STATES", "0")
    monkeypatch.delenv("VLT_NATIVE_PAIRHMM", raising=False)
    monkeypatch.delenv("VLT_PALLAS_PAIRHMM", raising=False)


def _jax(params):
    """The JAX package's copy of a port ``GapParams`` / ``HopParams``."""
    if params is None:
        return None
    return {GapParams: JaxGapParams, HopParams: JaxHopParams}[type(params)](**vars(params))


def _wavefront(alleles, reads, quals, gap):
    """JAX ``_forward_impl``, full forward (band off)."""
    B = len(alleles)
    X = -(-max(len(a) for a in alleles) // 32) * 32
    Y = max(32, -(-max(len(r) for r in reads) // 32) * 32)
    al = np.zeros((B, X), np.uint8)
    rd = np.zeros((B, Y), np.uint8)
    mis = np.full((B, Y), NEG_INF, np.float32)
    alen = np.zeros(B, np.int32)
    rlen = np.zeros(B, np.int32)
    for b, (a, r, q) in enumerate(zip(alleles, reads, quals)):
        a = np.frombuffer(bytes(a), np.uint8) & 0xDF
        al[b, : len(a)] = a
        rd[b, : len(r)] = np.asarray(r, np.uint8) & 0xDF
        mis[b, : len(r)] = -np.asarray(q, np.float64) * math.log(10) / 10
        alen[b], rlen[b] = len(a), len(r)
    out = _forward_impl(
        jnp.asarray(al), jnp.asarray(alen), jnp.asarray(rd), jnp.asarray(mis),
        jnp.asarray(rlen), jnp.asarray(gap), jnp.asarray(np.full(B, -1, np.int32)),
        X, Y,
    )
    return np.asarray(out, dtype=np.float64)


def _sets():
    sets = {"synth3": pairhmm_items(21, 3), "synth11": pairhmm_items(21, 11)}
    sets.update(pairhmm_edge_items())
    return sets


def _rel(got, ref):
    ok = ref > -1e29
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1.0)))


@pytest.mark.parametrize("general", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("name", sorted(_sets()))
def test_plain_kernel_matches_jax(name, general):
    alleles, reads, quals = _sets()[name]
    gap = GAP_ONT if general else GAP
    jax_fn = jpp.pallas_general_forward if general else jpp.pallas_exact_forward
    got = phc.forward_items(alleles, reads, quals, gap, "cpu", general)
    pallas = jax_fn(alleles, reads, quals, gap, interpret=True)
    wave = _wavefront(alleles, reads, quals, gap)
    assert got.dtype == np.float64 and got.shape == (len(alleles),)
    # the same items are impossible (-1e30) for the port and the Pallas
    # kernel; the log-space wavefront may still find a path where the float32
    # linear-space column kernels underflow, but only one below e^-300
    assert np.array_equal(got <= -1e29, pallas <= -1e29)
    assert np.all(wave[got <= -1e29] < -300.0)
    live = got > -1e29
    assert _rel(got, pallas) < TOL, _rel(got, pallas)
    assert _rel(got[live], wave[live]) < TOL, _rel(got[live], wave[live])
    empty = np.array([len(r) == 0 for r in reads])
    assert np.all(got[empty] == -1e30)


def test_items_are_the_jax_tests_synth_set():
    from test_pallas_pairhmm import _synth

    for seed in (3, 11):
        a, r, q = _synth(n=21, seed=seed)
        b, s, t = pairhmm_items(21, seed)
        assert a == b
        assert all(np.array_equal(x, y) for x, y in zip(r, s))
        assert all(np.array_equal(x, y) for x, y in zip(q, t))


def test_pack_matches_jax_byte_for_byte():
    alleles, reads, quals = pairhmm_items(21, 3)
    alleles = alleles + [b"acgtNN"]
    reads = reads + [np.zeros(0, np.uint8)]
    quals = quals + [np.zeros(0, np.uint8)]
    (ja, jr, jq, jal, jrl, jc), jn, jx, jy = jpp.pack_exact_batch(alleles, reads, quals, GAP)
    (ta, tr, tq, tal, trl, tc), tn, tx, ty = phc.pack_exact_batch(alleles, reads, quals, GAP)
    n = len(alleles)
    assert (jn, jx, jy) == (tn, tx, ty) == (n, jx, jy)
    for j, t in ((ja, ta), (jr, tr), (jq, tq)):
        assert t.dtype == j.dtype == np.uint8
        assert t.tobytes() == j[:n].tobytes()
        assert not j[n:].any()  # the TPU's tile padding, which the port drops
    assert tal.dtype == trl.dtype == np.int32
    assert np.array_equal(tal, jal[0, :n]) and np.array_equal(trl, jrl[0, :n])
    assert trl[-1] == 1  # the empty read is clamped to one column
    assert tc.tobytes() == jc[0].tobytes()


def test_general_coef_matches_jax(monkeypatch):
    seen = {}

    def capture(allele, read, qual, alen, rlen, coef, x_pad, y_pad, interpret=False):
        seen["coef"] = np.asarray(coef)
        return jnp.zeros(allele.shape[0], jnp.float32)

    monkeypatch.setattr(jpp, "_pallas_forward_general", capture)
    alleles, reads, quals = pairhmm_items(4, 3)
    jpp.pallas_general_forward(alleles, reads, quals, GAP_ONT)
    assert phc.general_coef(GAP_ONT).tobytes() == seen["coef"][0].tobytes()


def _parent_rows(Xp):
    """Allele rows the kernels' earlier one-warp-per-item layout computed: 32 lanes x
    the smallest power of two >= Xp/32, at least 2."""
    r = 2
    while r < -(-Xp // 32):
        r *= 2
    return 32 * r


# panel widths the tile policies are checked at: the edges of each tile's
# rows and the packed widths of the preprocess windows
TILE_POLICY_WIDTHS = [1, 8, 31, 32, 33, 64, 65, 96, 100, 128, 129, 160, 192, 224, 256, 300,
                      384, 512, 513, 768, 1000, 1024]


@pytest.mark.parametrize("name", sorted(pairhmm_tile_items()))
def test_plain_k3_matches_jax_on_the_tile_sets(name):
    """The sets that K3's tiled layout is checked on, on the card, against
    its plain version: here the plain version against the JAX Pallas kernel
    (interpret mode)."""
    alleles, reads, quals = pairhmm_tile_items()[name]
    got = phc.forward_items(alleles, reads, quals, GAP_ONT, "cpu", True)
    pallas = jpp.pallas_general_forward(alleles, reads, quals, GAP_ONT, interpret=True)
    assert np.array_equal(got <= -1e29, pallas <= -1e29)
    assert _rel(got, pallas) < TOL, _rel(got, pallas)


def _spy(monkeypatch):
    calls = []
    for module, name in ((phc, "exact_forward"), (phc, "general_forward"),
                         (phc, "positional_forward"), (pwf, "banded_forward")):
        fn = getattr(module, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(module, name, spy)
    # the wavefront route reaches its wrappers through WRAPPERS
    monkeypatch.setitem(pwf.WRAPPERS, "banded", pwf.banded_forward)
    return calls


def _route_values(alleles, reads, quals, gap, kernel, hop=None):
    """What the route of ``kernel`` computes on the CPU (full window)."""
    if kernel == "banded_forward":
        return pwf.forward_items(alleles, reads, quals, None, gap, "cpu")
    return phc.forward_items(alleles, reads, quals, gap, "cpu",
                             kernel == "general_forward", hop=hop)


@pytest.mark.parametrize(
    "gaps,kernel",
    [(DEFAULT_GAPS, "exact_forward"), (ONT_GAPS, "general_forward"),
     (GapParams(prob_insertion_extend_artifact=math.log(0.2)), "banded_forward")],
    ids=["zero_extension", "finite_extension", "one_finite_extension"],
)
def test_dispatch(monkeypatch, gaps, kernel):
    """K2 at zero extension, K3 when both extensions are finite; with one
    finite extension the JAX package's banded wavefront (its K3 route wants
    both, ops/pairhmm.py:687)."""
    calls = _spy(monkeypatch)
    alleles, reads, quals = pairhmm_items(9, 11)
    hmm = BatchedPairHMM(gaps, device="cpu")
    out = hmm.forward(alleles, reads, quals, [None] * len(alleles))
    assert calls == [kernel]
    ref = _route_values(alleles, reads, quals, hmm.gap, kernel)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize(
    "gaps,hop,kernel",
    [(DEFAULT_GAPS, HOP, "positional_forward"), (ONT_GAPS, HOP, "positional_forward"),
     (DEFAULT_GAPS, HopParams(), "positional_forward"),
     (DEFAULT_GAPS, None, "banded_forward"), (ONT_GAPS, None, "general_forward")],
    ids=["hop_zero_ext", "hop_finite_ext", "hop_all_inf", "no_hop_zero_ext", "no_hop_finite_ext"],
)
def test_dispatch_homopolymer(monkeypatch, gaps, hop, kernel):
    """mode="homopolymer" goes to K4 whenever hop params are given (the
    estimate's default HopParams() of -inf included), whatever the gap
    model; without hop params to K3 when both extensions are finite, else
    to the banded wavefront (the JAX package's K2 route wants mode
    "exact")."""
    calls = _spy(monkeypatch)
    alleles, reads, quals = pairhmm_items(9, 11)
    hmm = BatchedPairHMM(gaps, hop, mode="homopolymer", device="cpu")
    out = hmm.forward(alleles, reads, quals, [None] * len(alleles))
    assert calls == [kernel]
    ref = _route_values(alleles, reads, quals, hmm.gap, kernel, hop=hop)
    assert np.array_equal(out, ref)


def test_dispatch_refuses_what_is_not_ported():
    alleles, reads, quals = pairhmm_items(3, 3)
    with pytest.raises(RuntimeError, match="no device"):
        BatchedPairHMM(DEFAULT_GAPS).forward(alleles, reads, quals)
    with pytest.raises(ValueError):
        BatchedPairHMM(DEFAULT_GAPS, device="cpu").forward(alleles, reads[:2], quals)
    assert BatchedPairHMM(DEFAULT_GAPS, device="cpu").forward([], [], []).shape == (0,)


@pytest.mark.parametrize("gaps", [DEFAULT_GAPS, ONT_GAPS], ids=["zero", "ont"])
def test_state_carried_from_jax(gaps):
    jax_hmm = JaxPairHMM(_jax(gaps), hop_params=JaxHopParams(), mode="exact")
    hmm = pairhmm_from_jax(jax_hmm, "cpu")
    assert hmm.gap.tobytes() == jax_hmm.gap.tobytes()
    assert (hmm.mode, str(hmm.device)) == ("exact", "cpu")
    assert type(hmm.hop) is HopParams and vars(hmm.hop) == vars(jax_hmm.hop)
    # both packages pack the same coefficient vectors from it
    _, _, _, _, _, jc = jpp.pack_exact_batch([b"AC"], [b"A"], [b"\x1e"], jax_hmm.gap)[0]
    assert phc.exact_coef(hmm.gap).tobytes() == jc[0].tobytes()


def test_state_carried_from_jax_homopolymer(monkeypatch):
    """A JAX homopolymer ``BatchedPairHMM`` maps to a port one whose gap
    panels and K4 results agree with the JAX kernel route's."""
    jax_hmm = JaxPairHMM(_jax(ONT_GAPS), hop_params=_jax(HOP_MIXED), mode="homopolymer")
    hmm = pairhmm_from_jax(jax_hmm, "cpu")
    assert hmm.gap.tobytes() == jax_hmm.gap.tobytes()
    assert hmm.mode == "homopolymer" and type(hmm.hop) is HopParams
    assert vars(hmm.hop) == vars(jax_hmm.hop)
    alleles, reads, quals = _homopolymer_items(12, 5)
    jax_out, panels = _jax_k4_route(monkeypatch, jax_hmm, alleles, reads, quals)
    assert _rel(hmm.forward(alleles, reads, quals), jax_out) < TOL
    for got, ref in zip(_port_panels(hmm, alleles, reads, quals), panels):
        assert got.tobytes() == ref.tobytes()


def _homopolymer_items(n, seed):
    """Ragged items whose alleles and reads hold homopolymer runs (2-12
    bases), the read cut from its allele with a run-length slip, N bases,
    lowercase stretches, and an empty read."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    alleles, reads, quals = [], [], []
    for k in range(n):
        runs = acgt[rng.integers(0, 4, 40)]
        lens = rng.integers(1, 13, 40)
        a = np.repeat(runs, lens)[: int(rng.integers(30, 200))].copy()
        a[rng.random(len(a)) < 0.03] = ord("N")
        lo = int(rng.integers(0, max(1, len(a) - 60)))
        r = a[lo : lo + int(rng.integers(20, 100))].copy()
        if len(r) > 12:  # a slip: one run base more or less
            q = int(rng.integers(1, len(r) - 1))
            r = np.insert(r, q, r[q]) if k % 2 else np.delete(r, q)
        if k % 3 == 0:
            a[5:25] |= 0x20  # lowercase (N stays N: 0x4E | 0x20 = 'n')
            r[:10] |= 0x20
        if k == n - 1:
            r = np.zeros(0, np.uint8)
        alleles.append(a.tobytes())
        reads.append(r)
        quals.append(rng.integers(10, 41, len(r)).astype(np.uint8))
    return alleles, reads, quals


def _jax_k4_route(monkeypatch, jax_hmm, alleles, reads, quals):
    """The JAX package's K4 route (Pallas in interpret mode) and the LINEAR
    io / ie / do / de panels it hands the kernel, cut to the items."""
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "0")
    monkeypatch.setenv("VLT_PALLAS_PAIRHMM", "1")
    # tests/test_hop_pairhmm.py turns the hop-state mode on when imported
    monkeypatch.setenv("VLT_HOP_STATES", "0")
    seen = {}
    jit_fn = jpp._pallas_forward_positional

    def capture(allele, read, qual, alen, rlen, io, ie, do, de, x_pad, y_pad, interpret=False):
        seen["panels"] = [np.asarray(x)[: len(alleles)] for x in (io, ie, do, de)]
        return jit_fn(allele, read, qual, alen, rlen, io, ie, do, de, x_pad, y_pad,
                      interpret=True)

    monkeypatch.setattr(jpp, "_pallas_forward_positional", capture)
    out = jax_hmm.forward(alleles, reads, quals)
    return out, seen["panels"]


def _port_panels(hmm, alleles, reads, quals):
    """The port's K4 panels of the same items (numpy)."""
    args = phc.positional_args(alleles, reads, quals, hmm.gap, hmm.hop, "cpu")
    return [x.numpy() for x in args[5:]]


@pytest.mark.parametrize(
    "gaps,hop,seed",
    [(ONT_GAPS, HOP, 1), (DEFAULT_GAPS, HOP, 2), (ONT_GAPS, HOP_MIXED, 3),
     (DEFAULT_GAPS, HopParams(), 4)],
    ids=["ont_ln005", "default_ln005", "ont_mixed", "default_all_inf"],
)
def test_positional_gaps_match_jax_panels(monkeypatch, gaps, hop, seed):
    """(i) ``positional_gaps`` bit for bit against the panels of the JAX
    package's K4 route: runs, N, lowercase bytes, an empty read, padding."""
    alleles, reads, quals = _homopolymer_items(16, seed)
    jax_hmm = JaxPairHMM(_jax(gaps), hop_params=_jax(hop), mode="homopolymer")
    hmm = BatchedPairHMM(gaps, hop, mode="homopolymer", device="cpu")
    _, panels = _jax_k4_route(monkeypatch, jax_hmm, alleles, reads, quals)
    got = _port_panels(hmm, alleles, reads, quals)
    for name, g, ref in zip(("io", "ie", "do", "de"), got, panels):
        assert g.dtype == ref.dtype == np.float32 and g.shape == ref.shape, name
        assert g.tobytes() == ref.tobytes(), name
    # the runs did take the hop rate somewhere (unless it is -inf)
    if math.isfinite(hop.prob_ref_homopolymer[0]):
        assert (got[2] == np.float32(np.exp(np.float32(LN_005)))).any()


def _log_panels(alleles, reads):
    """The per-position LOG gap arrays of tests/test_pallas_pairhmm.py:188-222."""
    io, ie, do, de = [], [], [], []
    for a, r in zip(alleles, reads):
        io.append(np.float32(np.log(np.random.default_rng(1).uniform(1e-4, 2e-2, len(r)))))
        ie.append(np.float32(np.log(np.random.default_rng(2).uniform(0.05, 0.5, len(r)))))
        do.append(np.float32(np.log(np.random.default_rng(3).uniform(1e-4, 2e-2, len(a)))))
        de.append(np.float32(np.log(np.random.default_rng(4).uniform(0.05, 0.5, len(a)))))
    return io, ie, do, de


def _plain_k4(alleles, reads, quals, io, ie, do, de):
    """The port's plain K4 on LOG per-item arrays (linear panels as the JAX
    package's ``_linpanel`` builds them)."""
    (allele, read, qual, alen, rlen, _), n, Xp, Yp = phc.pack_exact_batch(
        alleles, reads, quals, GAP)

    def lin(rows, Np):
        panel = np.zeros((n, Np), np.float32)
        for b, row in enumerate(rows):
            panel[b, : len(row)] = np.exp(np.asarray(row, np.float32)[:Np])
        return panel

    args = phc.to_device((allele, read, qual, alen, rlen, lin(io, Yp), lin(ie, Yp),
                          lin(do, Xp), lin(de, Xp)), "cpu")
    out = phc.positional_forward(*args).numpy().astype(np.float64)
    return phc.mask_empty(out, reads)


def _hp_wavefront(alleles, reads, quals, io, ie, do, de):
    """JAX ``_forward_hp_impl``, full forward (band off), LOG panels."""
    B = len(alleles)
    X = -(-max(len(a) for a in alleles) // 32) * 32
    Y = max(32, -(-max(len(r) for r in reads) // 32) * 32)
    al = np.zeros((B, X), np.uint8)
    rd = np.zeros((B, Y), np.uint8)
    mis = np.full((B, Y), NEG_INF, np.float32)
    alen = np.zeros(B, np.int32)
    rlen = np.zeros(B, np.int32)
    pio, pie = np.full((B, Y), NEG_INF, np.float32), np.full((B, Y), NEG_INF, np.float32)
    pdo, pde = np.full((B, X), NEG_INF, np.float32), np.full((B, X), NEG_INF, np.float32)
    for b, (a, r, q) in enumerate(zip(alleles, reads, quals)):
        a = np.frombuffer(bytes(a), np.uint8) & 0xDF
        al[b, : len(a)] = a
        rd[b, : len(r)] = np.asarray(r, np.uint8) & 0xDF
        mis[b, : len(r)] = -np.asarray(q, np.float64) * math.log(10) / 10
        alen[b], rlen[b] = len(a), len(r)
        pio[b, : len(r)], pie[b, : len(r)] = io[b], ie[b]
        pdo[b, : len(a)], pde[b, : len(a)] = do[b], de[b]
    out = _forward_hp_impl(
        jnp.asarray(al), jnp.asarray(alen), jnp.asarray(rd), jnp.asarray(mis),
        jnp.asarray(rlen), jnp.asarray(pio), jnp.asarray(pie), jnp.asarray(pdo),
        jnp.asarray(pde), jnp.asarray(np.full(B, -1, np.int32)), X, Y,
    )
    return np.asarray(out, dtype=np.float64)


def _k4_sets():
    """(alleles, reads, quals, io, ie, do, de) with LOG per-position gaps:
    the JAX package's own K4 test inputs, the 50-base deletion chain under
    varying de, and homopolymer items with hop-rate panels."""
    from test_pallas_pairhmm import _synth

    out = {}
    alleles, reads, quals = _synth(n=13, seed=7)
    keep = [i for i in range(len(reads)) if len(reads[i]) > 0]
    alleles, reads, quals = ([x[i] for i in keep] for x in (alleles, reads, quals))
    out["pallas_test"] = (alleles, reads, quals, *_log_panels(alleles, reads))
    alleles, reads, quals = pairhmm_edge_items()["long_deletion"]
    rng = np.random.default_rng(8)
    ins = [np.log(rng.uniform(1e-3, 1e-2, len(reads[0]))).astype(np.float32),
           np.log(rng.uniform(0.1, 0.5, len(reads[0]))).astype(np.float32)]
    dels = [np.log(rng.uniform(1e-3, 1e-2, len(alleles[0]))).astype(np.float32),
            np.log(rng.uniform(0.3, 0.95, len(alleles[0]))).astype(np.float32)]
    out["long_deletion_varying_de"] = (alleles, reads, quals, [ins[0]], [ins[1]],
                                       [dels[0]], [dels[1]])
    alleles, reads, quals = _homopolymer_items(15, 9)
    alleles, reads, quals = alleles[:-1], reads[:-1], quals[:-1]  # no empty read
    out["homopolymer_hop"] = (alleles, reads, quals, *_hop_log_panels(alleles, reads, quals))
    return out


def _hop_log_panels(alleles, reads, quals):
    """LOG per-item io / ie / do / de of the port's panels at ONT-like base
    rates and hop rates of 0.05 inside homopolymer runs."""
    hmm = BatchedPairHMM(ONT_GAPS, HOP, mode="homopolymer", device="cpu")
    lin = _port_panels(hmm, alleles, reads, quals)
    logs = []
    for panel, items in zip(lin, (reads, reads, alleles, alleles)):
        with np.errstate(divide="ignore"):
            logs.append([np.maximum(np.log(p[: len(x)]), NEG_INF) for p, x in zip(panel, items)])
    return logs


@pytest.mark.parametrize("name", sorted(_k4_sets()))
def test_plain_k4_matches_jax(name):
    """(ii) plain K4 against the Pallas K4 in interpret mode, and (iii)
    against the log-space positional wavefront ``_forward_hp_impl``."""
    alleles, reads, quals, io, ie, do, de = _k4_sets()[name]
    got = _plain_k4(alleles, reads, quals, io, ie, do, de)
    pallas = jpp.pallas_positional_forward(alleles, reads, quals, io, ie, do, de,
                                           interpret=True)
    wave = _hp_wavefront(alleles, reads, quals, io, ie, do, de)
    assert np.all(got > -1e29) and np.all(pallas > -1e29)
    assert _rel(got, pallas) < TOL, _rel(got, pallas)
    assert _rel(got, wave) < TOL, _rel(got, wave)
    # the gaps matter: the constant-gap K3 gives another answer
    if name == "long_deletion_varying_de":
        k3 = phc.forward_items(alleles, reads, quals, GAP_ONT, "cpu", True)
        assert abs(k3[0] - got[0]) > 0.1


@pytest.mark.parametrize("name", sorted(pairhmm_tile_items()))
def test_plain_k4_matches_jax_on_the_tile_sets(name):
    """The sets that K4's tiled layout is checked on, on the card, against
    its plain version (reads of 1-100 bases in one warp, allele lengths off
    the rows per lane, panel widths 32-1056): here the plain K4 against the
    JAX Pallas K4 (interpret mode), with hop rates inside the runs.  Reads
    longer than their allele (``width_*``: up to 28 bases) work at the
    underflow edge, where XLA flushes float32 denormals and torch keeps them
    (ROADMAP C, :func:`test_denormals_explain_the_difference_from_xla`), so
    the plain K4 runs here with denormals flushed as XLA runs it."""
    alleles, reads, quals = pairhmm_tile_items()[name]
    panels = _hop_log_panels(alleles, reads, quals)
    torch.set_flush_denormal(True)
    try:
        got = _plain_k4(alleles, reads, quals, *panels)
    finally:
        torch.set_flush_denormal(False)
    pallas = jpp.pallas_positional_forward(alleles, reads, quals, *panels, interpret=True)
    assert np.array_equal(got <= -1e29, pallas <= -1e29)
    assert _rel(got, pallas) < TOL, _rel(got, pallas)


# each kernel's tile policy, C entry, tiled kernel, and wrapper inputs
TILED = {
    "exact": (phc.exact_tile, "vlt_pairhmm_exact", "pairhmm_exact_tiled_kernel", "EXACT"),
    "general": (phc.general_tile, "vlt_pairhmm_general", "pairhmm_general_tiled_kernel",
                "GENERAL"),
    "positional": (phc.positional_tile, "vlt_pairhmm_positional",
                   "pairhmm_positional_tiled_kernel", "POSITIONAL"),
}


def _policy_checks(kind, Xp, tile):
    """What each policy adds to covering the panel: K3 takes 16 lanes
    wherever a 16-lane tile pads no more; K2 takes K3's tile; K4 pads as
    K3 does and, of the tiles that pad as little, takes the fewest lanes."""
    lanes, rows = tile
    if kind == "general":
        if any(t[0] == 16 and t[0] * t[1] == lanes * rows for t in phc.GENERAL_TILES):
            assert lanes == 16
    elif kind == "exact":
        assert tile == phc.general_tile(Xp)
    else:
        assert lanes * rows == np.prod(phc.general_tile(Xp))
        assert not any(t[0] < lanes and t[0] * t[1] == lanes * rows for t in phc.GENERAL_TILES)


@pytest.mark.parametrize("Xp", TILE_POLICY_WIDTHS)
@pytest.mark.parametrize("kind", sorted(TILED))
def test_tile_fits_the_panel(kind, Xp):
    """The kernel's tile covers the panel, its lanes divide a warp, and it
    pads no more rows than the one-warp-per-item layout did (at most one
    lane's rows more than Xp where a tile of that size exists)."""
    lanes, rows = TILED[kind][0](Xp)
    assert (lanes, rows) in phc.GENERAL_TILES
    assert 32 % lanes == 0 and lanes >= 8
    assert Xp <= lanes * rows <= _parent_rows(Xp)
    _policy_checks(kind, Xp, (lanes, rows))


@pytest.mark.parametrize("kind", sorted(TILED))
def test_tile_every_width(kind):
    policy = TILED[kind][0]
    for Xp in range(1, 1025):
        tile = policy(Xp)
        assert tile in phc.GENERAL_TILES and Xp <= np.prod(tile) <= _parent_rows(Xp)
        _policy_checks(kind, Xp, tile)
        if kind == "positional":  # K3's tile but at 65-128 rows, where K4 takes 8 lanes
            assert tile == (phc.general_tile(Xp, lanes=8) if 64 < Xp <= 128
                            else phc.general_tile(Xp))
    # the packed widths (multiples of 32) of the preprocess windows: exact
    for Xp in (32, 64, 96, 128, 160, 192, 256):
        assert np.prod(policy(Xp)) == Xp
    # the main path's 128-row panels, and the bench shapes' 160 and 256 rows
    assert policy(128) == {"exact": (16, 8), "general": (16, 8), "positional": (8, 16)}[kind]
    assert policy(160) == (16, 10) and policy(256) == (16, 16)
    assert policy(1056) == policy(32 * 32 * 32) == (32, 32)
    # the limits the variant script's policies use
    assert phc.general_tile(128, lanes=8) == (8, 16)
    assert phc.general_tile(160, max_rows=8) == (32, 5)


@pytest.mark.parametrize("kind", sorted(TILED))
def test_tiles_are_the_kernel_instantiations(kind):
    """GENERAL_TILES lists exactly the (lanes, rows) pairs the CUDA source
    instantiates (VLT_GENERAL_TILES), and the launcher instantiates the
    kernel's tiled kernel at each of them and reaches it from the kernel's C
    entry, so a tile that the wrapper takes always launches."""
    import re
    from pathlib import Path

    _, entry, kernel, kind_enum = TILED[kind]
    src = (Path(phc.__file__).parent.parent / "csrc" / "pairhmm_column.cu").read_text()
    block = re.search(r"#define VLT_GENERAL_TILES\(X\)(.*?)\n\n", src, re.S).group(1)
    pairs = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", block))
    assert pairs == phc.GENERAL_TILES
    launch = src[src.index("int launch_tiled("):]
    launch = launch[: launch.index("\n}\n")]
    tile_macro = re.search(r"#define VLT_TILE\(l, r\)(.*?)\n  VLT_GENERAL_TILES\(VLT_TILE\)",
                           launch, re.S)
    assert tile_macro and f"{kernel}<l, r>" in tile_macro.group(1)
    body = src[src.index(f'extern "C" int {entry}('):]
    assert f"launch_tiled<{kind_enum}>(" in body[: body.index("\n}\n")]


def _tile_args(kind, alleles, reads, quals):
    if kind == "positional":
        return phc.positional_args(alleles, reads, quals, GAP_ONT, HOP, "cpu")
    args, *_ = phc.pack_exact_batch(alleles, reads, quals, GAP if kind == "exact" else GAP_ONT)
    if kind == "general":
        args = args[:5] + (phc.general_coef(GAP_ONT),)
    return phc.to_device(args, "cpu")


@pytest.mark.parametrize("tile", [(8, 4), (16, 6), (7, 32), (32, 32)])
@pytest.mark.parametrize("kind", sorted(TILED))
def test_forward_refuses_a_tile_that_does_not_take_the_panel(kind, tile):
    """The wrapper checks the tile on the CPU too: one that does not cover
    the panel, or that the source does not instantiate, raises."""
    alleles, reads, quals = pairhmm_shape_items(3, 300, 50)  # Xp = 320
    args = _tile_args(kind, alleles, reads, quals)
    fn = getattr(phc, f"{kind}_forward")
    if tile == (32, 32):
        assert np.isfinite(fn(*args, tile=tile).numpy()).all()
        return
    with pytest.raises(ValueError, match="does not take"):
        fn(*args, tile=tile)


@pytest.mark.parametrize("name", sorted(pairhmm_tile_items()))
def test_plain_k2_matches_jax_on_the_tile_sets(name):
    """The sets that K2's tiled layout is checked on, on the card, against
    its plain version: here the plain version against the JAX Pallas kernel
    (interpret mode), the same finiteness.  Reads longer than their allele
    (``width_*``: up to 7 insertions with no extension, e^-90 and below)
    work at the underflow edge, where XLA flushes float32 denormals and
    torch keeps them (ROADMAP C,
    :func:`test_denormals_explain_the_difference_from_xla`), so the plain
    K2 runs here with denormals flushed as XLA runs it."""
    alleles, reads, quals = pairhmm_tile_items()[name]
    torch.set_flush_denormal(True)
    try:
        got = phc.forward_items(alleles, reads, quals, GAP, "cpu", False)
    finally:
        torch.set_flush_denormal(False)
    pallas = jpp.pallas_exact_forward(alleles, reads, quals, GAP, interpret=True)
    assert np.array_equal(np.isfinite(got), np.isfinite(pallas))
    assert np.array_equal(got <= -1e29, pallas <= -1e29)
    assert _rel(got, pallas) < TOL, _rel(got, pallas)


def test_denormals_explain_the_difference_from_xla():
    """XLA on the CPU (and the TPU) flushes float32 denormals; torch on the
    CPU and the card keep them.  On reads that align nowhere the f32 forward
    works at the underflow edge, so the two differ by whole units in the log;
    with denormals flushed the port reproduces the Pallas kernel, and with
    them kept it is closer to a float64 evaluation of the same recurrence."""
    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    alleles = [acgt[rng.integers(0, 4, 115)].tobytes() for _ in range(16)]
    reads = [acgt[rng.integers(0, 4, 100)] for _ in range(16)]
    quals = [np.clip(rng.normal(36, 3, 100), 10, 41).astype(np.uint8) for _ in range(16)]
    pallas = jpp.pallas_exact_forward(alleles, reads, quals, GAP, interpret=True)
    kept = phc.forward_items(alleles, reads, quals, GAP, "cpu", False)
    torch.set_flush_denormal(True)
    try:
        flushed = phc.forward_items(alleles, reads, quals, GAP, "cpu", False)
    finally:
        torch.set_flush_denormal(False)
    assert _rel(flushed, pallas) < TOL
    exact = np.array([_f64_exact(a, r, q, GAP) for a, r, q in zip(alleles, reads, quals)])
    assert np.abs(kept - exact).max() <= np.abs(pallas - exact).max()


def _f64_exact(allele, read, qual, gap):
    """The K2 recurrence in float64 without rescaling (reference value)."""
    a = np.frombuffer(allele, np.uint8) & 0xDF
    rd = np.asarray(read, np.uint8) & 0xDF
    mis = np.exp(np.asarray(qual, np.float64) * -math.log(10) / 10)
    g_mi, g_md = math.exp(gap[0]), math.exp(gap[1])
    t_mm = 1.0 - g_mi - g_md
    p1, p2, mprev = np.zeros(len(a)), np.zeros(len(a)), 0.0
    for j in range(1, len(rd) + 1):
        rj, mj = rd[j - 1], mis[j - 1]
        e = np.where(a == rj, 1 - mj, np.where(rj == ord("N"), 0.25, mj / 3))
        sh1 = np.concatenate([[0.0], p1[:-1]])
        sh2 = np.concatenate([[0.0, 0.0], p1[:-2]])
        ins1 = np.concatenate([[0.0], p2[:-1]])
        start = 1.0 if j == 1 else (g_mi * mis[0] if j == 2 else 0.0)
        col = e * (t_mm * sh1 + g_md * sh2 + g_mi * mprev * ins1 + start)
        p2, p1, mprev = p1, col, mj
    i_sum = mis[-1] * g_mi * ((len(a) + 1) if len(rd) == 1 else p2.sum())
    return math.log(p1.sum() + i_sum)

