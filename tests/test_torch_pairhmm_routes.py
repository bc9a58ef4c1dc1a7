"""The port's pair-HMM routes against the JAX package's: the wavefronts, the
native host forward and the route table of ``BatchedPairHMM.forward``.

* The plain wavefronts (``ops/pairhmm_wavefront.py``) against the JAX
  ``_forward_impl``, ``_forward_hp_impl`` and ``_forward_hop_impl`` on
  ``tests/test_hop_pairhmm.py::_synth``-style items (homopolymer-rich
  alleles of 40-90 bases, reads of 30-60 with run-length slips), with and
  without the realigner's bands (edit distance + 4): within 1e-5 *
  max(1, |x|), -1e30 exactly where JAX gives it.  Measured: banded and
  positional equal JAX bit for bit, the hop flavour within 1.1e-7.
* The port's native routes (its copy of the native host library) against
  the JAX wavefronts at 1e-4 relative, the JAX package's own native-vs-
  wavefront limit (tests/test_hop_pairhmm.py:73: float64 host against float32
  device): the linear and ``VLT_PAIRHMM_F64LOG=1`` profiles, exact and
  homopolymer mode, and the hop-state model; zero hop rates reduce the hop
  model to the exact route within 1e-9.
* The route table: (mode, gap model, hop params, ``VLT_HOP_STATES``,
  ``VLT_NATIVE_PAIRHMM``, ``VLT_PALLAS_PAIRHMM``, device) against the route
  the JAX package takes with the same switches (the port's unset
  ``VLT_PALLAS_PAIRHMM`` is JAX's TPU default, "1" on its CPU backend).  In
  the two cases where the port ran a column kernel that JAX does not take
  (homopolymer mode without hop params at zero extension; one finite
  extension) the values now equal JAX's banded wavefront.  The native route
  raises where the native library does not load.

The JAX side never loads its own native library (``VLT_NATIVE_PAIRHMM=0``,
or ``_use_native`` set on the JAX instance): its build races under xdist.
"""

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import varlociraptor_tpu.ops.pallas_pairhmm as jpp
import varlociraptor_tpu.ops.pairhmm as jph
from varlociraptor_tpu.estimation.alignment_properties import GapParams as JaxGapParams
from varlociraptor_tpu.estimation.alignment_properties import HopParams as JaxHopParams
from varlociraptor_tpu_torch.bench_utils import semiglobal_distances
from varlociraptor_tpu_torch.estimation.alignment_properties import GapParams, HopParams
from varlociraptor_tpu_torch.io import native
from varlociraptor_tpu_torch.ops import pairhmm as pph
from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf

TOL = 1e-5
NATIVE_TOL = 1e-4
ZERO_EXT = GapParams(math.log(2.8e-6), math.log(5.1e-6), -math.inf, -math.inf)
ONT = GapParams(math.log(5.1e-3), math.log(4.2e-3), math.log(0.35), math.log(0.42))
ONE_FINITE = GapParams(math.log(2.8e-6), math.log(5.1e-6), math.log(0.2), -math.inf)
HOP = HopParams(
    [math.log(p) for p in (0.01, 0.02, 0.015, 0.005)],
    [math.log(p) for p in (0.008, 0.01, 0.02, 0.004)],
    [math.log(0.3)] * 4,
    [math.log(0.25)] * 4,
)
GAPS = {"zero_ext": ZERO_EXT, "ont": ONT, "one_finite": ONE_FINITE}


def _jax(params):
    """The JAX package's copy of a port ``GapParams`` / ``HopParams``."""
    if params is None:
        return None
    return {GapParams: JaxGapParams, HopParams: JaxHopParams}[type(params)](**vars(params))


def _synth(n=24, seed=5):
    """``tests/test_hop_pairhmm.py::_synth`` at small shapes: alleles of 40
    or 90 bases built from runs, reads of 30 or 60 cut from them with up to
    two run-length slips, quality 30.  Returns (alleles, reads, quals)."""
    rnd = random.Random(seed)
    alleles, reads, quals = [], [], []
    for _ in range(n):
        alen = rnd.choice([40, 90])
        a = bytearray()
        while len(a) < alen:
            a += bytes([rnd.choice(b"ACGT")]) * rnd.choice([1, 1, 1, 2, 3, 5])
        a = bytes(a[:alen])
        rlen = rnd.choice([30, 60])
        p = rnd.randrange(max(1, alen - rlen))
        r = bytearray(a[p : p + rlen])
        for _ in range(rnd.randrange(3)):
            q = rnd.randrange(len(r))
            if rnd.random() < 0.5:
                r.insert(q, r[q])
            else:
                del r[q]
        alleles.append(a)
        reads.append(np.frombuffer(bytes(r), dtype=np.uint8))
        quals.append(np.full(len(r), 30, dtype=np.uint8))
    return alleles, reads, quals


ITEMS = _synth()
BANDS = [int(d) + 4 for d in semiglobal_distances(ITEMS[0], ITEMS[1])]


def _bands(banded):
    return [d if k % 3 else None for k, d in enumerate(BANDS)] if banded else None


def _jax_wavefront(flavour, gap, hop, dists):
    """The JAX wavefront of ``flavour`` on ITEMS, packed as the JAX package
    packs them (its pow2 batch padding dropped: the values do not depend
    on it)."""
    a, al, r, m, rl, me = pwf.pack_wavefront(*ITEMS, dists)
    X, Y = a.shape[1], r.shape[1]
    j = [jnp.asarray(x) for x in (a, al, r, m, rl)]
    if flavour == "banded":
        out = jph._forward_impl(*j, jnp.asarray(gap), jnp.asarray(me), X, Y)
    elif flavour == "positional":
        panels = [jnp.asarray(p) for p in pwf.positional_panels(a, r, gap, hop)]
        out = jph._forward_hp_impl(*j, *panels, jnp.asarray(me), X, Y)
    else:
        out = jph._forward_hop_impl(*j, jnp.asarray(gap), jnp.asarray(pwf.hop16(hop)),
                                    jnp.asarray(me), X, Y)
    return np.asarray(out, dtype=np.float64)


def _rel(got, ref):
    assert np.array_equal(got <= -1e29, ref <= -1e29)
    ok = ref > -1e29
    return float(np.max(np.abs(got[ok] - ref[ok]) / np.maximum(1.0, np.abs(ref[ok]))))


def _gap_array(gaps):
    return pph.BatchedPairHMM(gaps).gap


@pytest.mark.parametrize("banded", [False, True], ids=["full", "banded"])
@pytest.mark.parametrize("flavour", ["banded", "positional", "hop"])
def test_plain_wavefront_matches_jax(flavour, banded):
    gap = _gap_array(ONT)
    hop = None if flavour == "banded" else HOP
    dists = _bands(banded)
    got = pwf.forward_items(*ITEMS, dists, gap, "cpu", hop=hop, hop_states=flavour == "hop")
    ref = _jax_wavefront(flavour, gap, hop, dists)
    assert _rel(got, ref) <= TOL, _rel(got, ref)
    if banded:  # the band prunes: the banded values are not the full ones
        full = pwf.forward_items(*ITEMS, None, gap, "cpu", hop=hop,
                                 hop_states=flavour == "hop")
        assert np.any(got != full)


def test_wavefront_pack_matches_jax_panels():
    """The packed panels and the positional flavour's LOG panels are the
    ones the JAX wavefront route builds, byte for byte (its batch cut to the
    item count)."""
    a, al, r, m, rl, me = pwf.pack_wavefront(*ITEMS, _bands(True))
    n = len(ITEMS[0])
    assert (al[:n] == [len(x) for x in ITEMS[0]]).all() and me.dtype == np.int32
    for k, (x, y, q) in enumerate(zip(*ITEMS)):
        assert a[k, : len(x)].tobytes() == bytes(x).upper()
        assert r[k, : len(y)].tobytes() == bytes(y).upper()
        ref = (-np.asarray(q, np.float64) * math.log(10.0) / 10.0).astype(np.float32)
        assert m[k, : len(y)].tobytes() == ref.tobytes()
    jhmm = jph.BatchedPairHMM(_jax(ONT), _jax(HOP), mode="homopolymer")
    ours = pwf.positional_panels(a, r, jhmm.gap, HOP)
    refs = (jhmm._positional_gaps(r, rl, jhmm.gap[0], jhmm.gap[2], HOP.prob_seq_homopolymer,
                                  HOP.prob_seq_extend_homopolymer)
            + jhmm._positional_gaps(a, al, jhmm.gap[1], jhmm.gap[3],
                                    HOP.prob_ref_homopolymer,
                                    HOP.prob_ref_extend_homopolymer))
    for got, ref in zip(ours, refs):
        assert got.tobytes() == ref.tobytes()
    assert pwf.hop16(HOP).tobytes() == jhmm._hop16().tobytes()
    assert pwf.hop16(HopParams()).tobytes() == jph.BatchedPairHMM(
        _jax(ONT), JaxHopParams(), mode="homopolymer")._hop16().tobytes()


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("the port's native host library needs g++ and zlib")


@pytest.mark.parametrize(
    "mode,flavour,f64log",
    [("exact", "banded", False), ("exact", "banded", True),
     ("homopolymer", "positional", False), ("homopolymer", "positional", True),
     ("homopolymer", "hop", False)],
    ids=["linear", "f64log", "homopolymer_linear", "homopolymer_f64log", "hop"],
)
def test_native_route_matches_jax_wavefront(monkeypatch, native_lib, mode, flavour, f64log):
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "1")
    monkeypatch.setenv("VLT_HOP_STATES", "1" if flavour == "hop" else "0")
    if f64log:
        monkeypatch.setenv("VLT_PAIRHMM_F64LOG", "1")
    else:
        monkeypatch.delenv("VLT_PAIRHMM_F64LOG", raising=False)
    hop = HOP if mode == "homopolymer" else None
    hmm = pph.BatchedPairHMM(ONT, hop, mode=mode, device="cpu")
    assert hmm.route() == ("hop_native" if flavour == "hop" else "native")
    dists = _bands(True)
    got = hmm.forward(*ITEMS, dists)
    ref = _jax_wavefront(flavour, hmm.gap, hop, dists)
    assert _rel(got, ref) <= NATIVE_TOL, _rel(got, ref)


def test_zero_hops_reduce_to_exact_route(monkeypatch, native_lib):
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "1")
    monkeypatch.setenv("VLT_HOP_STATES", "1")
    dists = _bands(True)
    hh = pph.BatchedPairHMM(ZERO_EXT, HopParams(), mode="homopolymer", device="cpu")
    he = pph.BatchedPairHMM(ZERO_EXT, mode="exact", device="cpu")
    assert (hh.route(), he.route()) == ("hop_native", "native")
    np.testing.assert_allclose(hh.forward(*ITEMS, dists), he.forward(*ITEMS, dists),
                               rtol=1e-9, atol=1e-9)
    # the same on the hop wavefront against the banded one
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "0")
    assert hh.route() == "hop_wavefront"
    got = hh.forward(*ITEMS, dists)
    ref = _jax_wavefront("banded", hh.gap, None, dists)
    assert _rel(got, ref) <= TOL


# the route each entry point takes: the port's wrappers and the JAX package's
# functions (JAX imports its Pallas entries inside forward: patched on their
# module)
PORT_ROUTES = {
    "exact": (pph, "forward_items"), "native": (native, "pairhmm_forward_batch"),
    "hop_native": (native, "pairhmm_hop_batch"),
}
JAX_ROUTES = {
    "exact": (jpp, "pallas_exact_forward"), "general": (jpp, "pallas_general_forward"),
    "positional": (jpp, "pallas_positional_forward"),
    "banded_wavefront": (jph, "_forward_impl"),
    "positional_wavefront": (jph, "_forward_hp_impl"),
    "hop_wavefront": (jph, "_forward_hop_impl"),
}

# (mode, gaps, hop, VLT_HOP_STATES, VLT_NATIVE_PAIRHMM, VLT_PALLAS_PAIRHMM) -> route
ROUTE_TABLE = [
    ("exact", "zero_ext", None, None, None, None, "exact"),
    ("exact", "ont", None, None, None, None, "general"),
    ("exact", "one_finite", None, None, None, None, "banded_wavefront"),
    ("homopolymer", "zero_ext", None, None, None, None, "banded_wavefront"),
    ("homopolymer", "ont", None, None, None, None, "general"),
    ("homopolymer", "zero_ext", "hop", None, None, None, "positional"),
    ("homopolymer", "ont", "hop", "0", None, None, "positional"),
    ("homopolymer", "zero_ext", "hop", "1", None, None, "hop_wavefront"),
    ("homopolymer", "ont", "hop", "1", "1", None, "hop_native"),
    ("homopolymer", "zero_ext", "hop", "1", None, "0", "hop_wavefront"),
    ("exact", "zero_ext", "hop", "1", None, None, "exact"),
    ("exact", "zero_ext", None, None, None, "0", "banded_wavefront"),
    ("exact", "ont", None, None, None, "0", "banded_wavefront"),
    ("exact", "ont", None, None, None, "1", "general"),
    ("homopolymer", "ont", "hop", None, None, "0", "positional_wavefront"),
    ("exact", "zero_ext", None, None, "1", None, "native"),
    ("homopolymer", "ont", "hop", "0", "1", "0", "native"),
    ("exact", "ont", None, None, "false", None, "general"),
    ("exact", "ont", None, None, "0", "0", "banded_wavefront"),
]


def _setenv(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _spy_routes(monkeypatch, routes):
    """Replace each entry of ``routes`` by a stand-in that records its name
    and returns zeros of the batch's size (a tensor where the entry takes
    tensors)."""
    seen = []
    for name, (module, attr) in routes.items():
        def stand_in(*args, _name=name, **kwargs):
            seen.append(_name)
            if isinstance(args[0], torch.Tensor):
                return torch.zeros(args[0].shape[0])
            return np.zeros(len(args[0]) if isinstance(args[0], list) else args[0].shape[0])

        monkeypatch.setattr(module, attr, stand_in)
    return seen


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("mode,gaps,hop,hop_states,native_env,pallas,route", ROUTE_TABLE)
def test_route_table_matches_jax(monkeypatch, device, mode, gaps, hop, hop_states,
                                 native_env, pallas, route):
    hop = HOP if hop else None
    alleles, reads, quals = ITEMS
    # the JAX package with the same switches on its CPU backend: an unset
    # VLT_PALLAS_PAIRHMM is its TPU default, "1" here; the native switch on
    # the instance (its library is never loaded)
    _setenv(monkeypatch, "VLT_HOP_STATES", hop_states)
    _setenv(monkeypatch, "VLT_PALLAS_PAIRHMM", pallas or "1")
    jax_seen = _spy_routes(monkeypatch, JAX_ROUTES)
    monkeypatch.setattr(jph.BatchedPairHMM, "_forward_native",
                        lambda self, a, *r: jax_seen.append("native") or np.zeros(len(a)))
    monkeypatch.setattr("varlociraptor_tpu.io.native.pairhmm_hop_batch",
                        lambda *a, **k: jax_seen.append("hop_native") or np.zeros(len(a[0])))
    jhmm = jph.BatchedPairHMM(_jax(GAPS[gaps]), _jax(hop), mode=mode)
    jhmm._use_native = native_env not in (None, "0", "false")
    jhmm.forward(alleles, reads, quals, BANDS)
    # the port with the switches as given
    _setenv(monkeypatch, "VLT_PALLAS_PAIRHMM", pallas)
    _setenv(monkeypatch, "VLT_NATIVE_PAIRHMM", native_env)
    monkeypatch.setattr(native, "available", lambda: True)
    port_seen = _spy_routes(monkeypatch, PORT_ROUTES)

    def wavefront_items(alleles, *args, hop=None, hop_states=False):
        port_seen.append("hop_wavefront" if hop_states else
                         "banded_wavefront" if hop is None else "positional_wavefront")
        assert str(args[4]) == device
        return np.zeros(len(alleles))

    monkeypatch.setattr(pwf, "forward_items", wavefront_items)
    hmm = pph.BatchedPairHMM(GAPS[gaps], hop, mode=mode, device=device)
    assert hmm.route() == route
    hmm.forward(alleles, reads, quals, BANDS)
    column = {"exact": "exact", "general": "exact", "positional": "exact"}
    assert port_seen == [column.get(route, route)]
    assert jax_seen == [route]


def _forward_items_args(monkeypatch):
    """The column route's forward_items, recording its (general, hop)."""
    calls = []
    fn = pph.forward_items

    def spy(*args, general, hop=None):
        calls.append((general, hop is not None))
        return fn(*args, general=general, hop=hop)

    monkeypatch.setattr(pph, "forward_items", spy)
    return calls


@pytest.mark.parametrize("mode,gaps,hop,kernel", [
    ("exact", "zero_ext", None, (False, False)), ("exact", "ont", None, (True, False)),
    ("homopolymer", "ont", None, (True, False)), ("homopolymer", "zero_ext", "hop", (False, True)),
])
def test_column_routes_pick_their_kernel(monkeypatch, mode, gaps, hop, kernel):
    monkeypatch.setenv("VLT_HOP_STATES", "0")
    monkeypatch.delenv("VLT_PALLAS_PAIRHMM", raising=False)
    monkeypatch.delenv("VLT_NATIVE_PAIRHMM", raising=False)
    calls = _forward_items_args(monkeypatch)
    hmm = pph.BatchedPairHMM(GAPS[gaps], HOP if hop else None, mode=mode, device="cpu")
    hmm.forward(*(x[:4] for x in ITEMS))
    assert calls == [kernel]


@pytest.mark.parametrize("mode,gaps", [("homopolymer", "zero_ext"), ("exact", "one_finite")],
                         ids=["homopolymer_without_hop", "one_finite_extension"])
def test_routing_fault_cases_take_the_banded_wavefront(monkeypatch, mode, gaps):
    """The two cases where the port once ran K2 / K3 and JAX its banded
    wavefront: the values are now JAX's banded wavefront's."""
    monkeypatch.setenv("VLT_HOP_STATES", "0")
    monkeypatch.delenv("VLT_PALLAS_PAIRHMM", raising=False)
    monkeypatch.delenv("VLT_NATIVE_PAIRHMM", raising=False)
    hmm = pph.BatchedPairHMM(GAPS[gaps], mode=mode, device="cpu")
    assert hmm.route() == "banded_wavefront"
    dists = _bands(True)
    got = hmm.forward(*ITEMS, dists)
    ref = _jax_wavefront("banded", hmm.gap, None, dists)
    assert _rel(got, ref) <= TOL
    column = pph.forward_items(*ITEMS, hmm.gap, "cpu", general=gaps != "zero_ext")
    assert np.any(np.abs(column - got) > 1e-7), "the column kernel gives the same values"


def test_missing_native_library_raises(monkeypatch):
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "1")
    monkeypatch.setattr(native, "available", lambda: False)
    for mode, hop, states in (("exact", None, "0"), ("homopolymer", HOP, "1")):
        monkeypatch.setenv("VLT_HOP_STATES", states)
        hmm = pph.BatchedPairHMM(ONT, hop, mode=mode, device="cpu")
        with pytest.raises(RuntimeError, match="native host library"):
            hmm.forward(*ITEMS)


def test_wrappers_refuse_bad_inputs():
    _, (a, al, r, m, rl, g, me) = pwf.wavefront_args(*ITEMS, None, _gap_array(ONT), "cpu")
    with pytest.raises(TypeError, match="float32"):
        pwf.banded_forward(a, al, r, m.double(), rl, g, me)
    with pytest.raises(ValueError, match="gaps must be"):
        pwf.banded_forward(a, al, r, m, rl, m[0], me)
    with pytest.raises(ValueError, match="batch sizes"):
        pwf.banded_forward(a, al[:3], r, m, rl, g, me)
    assert pwf.forward_items([], [], [], None, _gap_array(ONT), "cpu").shape == (0,)
    with pytest.raises(ValueError, match="exceeds"):
        pwf.cols_per_thread(32 * 1024)
    assert [pwf.cols_per_thread(y) for y in (128, 1023, 1024, 4000)] == [1, 1, 2, 4]
