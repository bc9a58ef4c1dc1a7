"""The engine's event and MAP / AFD pass on the CPU (ops/assemble.py): with
its plain versions the engine agrees with the JAX package's engine on
tumor/normal, the l2fc scenario, the trio, one sample, ``--full-prior``, a
batch of one combination slot (B = 1), events compiled to False and a
two-point grid (no parabola), within the tolerances of
``compare.compare_outputs``; a CPU engine never launches the kernels; the
wrappers refuse what the kernels do not take.  The kernels themselves are
held to the plain versions on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from varlociraptor_tpu_torch.bench_utils import (
    L2FC_SCENARIO,
    ONE_SAMPLE_SCENARIO,
    PRESENT_SCENARIO,
    TRIO_SCENARIO,
    engine_inputs,
    full_prior_table,
    tumor_normal_engine,
)
from varlociraptor_tpu_torch.compare import compare_outputs
from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
from varlociraptor_tpu_torch.ops import assemble as asm
from varlociraptor_tpu_torch.ops.posterior import AFD_TOP_K
from test_torch_engine_modes import _mods, _scenario_engine

TUMOR_NORMAL = tumor_normal_scenario(0.75).doc


def _false_event_engine(m):
    """The tumor-normal engine with two events compiled to False (no
    branch; the second an artifact event) among the others
    (bench_utils.false_event_engine), in the package of ``m``."""
    events, grid_points = m.compile(m.Scenario(TUMOR_NORMAL), "chr1")
    events = (events[:2] + [m.ep.EventSpec("never", ())] + events[2:6]
              + [m.ep.EventSpec("never_artifact", (), is_artifact=True)] + events[6:])
    samples = [m.post.SampleConfig("tumor", contaminated_by=1, contamination_fraction=0.25),
               m.post.SampleConfig("normal")]
    kw = {"device": "cpu"} if m.pkg == "torch" else {}
    return m.post.PosteriorEngine(
        events, m.AFGrid.build(0.01, extra_points=grid_points), samples, resolution=0.01,
        all_uniform_prior=True, n_artifact_combos=m.n_art, **kw)


# name -> engine builder over the modules of either package
BUILDS = {
    "tumor_normal": _scenario_engine(TUMOR_NORMAL, 0.01, all_uniform=True),
    "l2fc": _scenario_engine(L2FC_SCENARIO, 0.05),
    "trio": _scenario_engine(TRIO_SCENARIO, 0.1, all_uniform=True),
    "single": _scenario_engine(ONE_SAMPLE_SCENARIO, 0.01),
    "g2": _scenario_engine(PRESENT_SCENARIO, 1.0, all_uniform=True),
    "false_event": _false_event_engine,
    "full_prior": _scenario_engine(TUMOR_NORMAL, 0.01, all_uniform=True),
    "b1": _scenario_engine(TUMOR_NORMAL, 0.01, all_uniform=True),
}


def _case(name):
    """(the port's engine, the JAX package's, engine.run's inputs, its
    ln_prior_joint)."""
    engine, jax_engine = BUILDS[name](_mods("torch")), BUILDS[name](_mods("jax"))
    pj = None
    if name == "g2":
        assert [v.size for v in engine.values_s] == [2]
    if name == "false_event":
        assert sum(not ix for ix in engine.event_branch_idx) == 2
    L = 8
    inputs = list(engine_inputs(engine, n_loci=L, depth=12, seed=4))
    if name == "full_prior":
        table = full_prior_table(_mods("torch").Scenario(TUMOR_NORMAL), engine)[0]
        pj = np.ascontiguousarray(np.broadcast_to(table, (L,) + table.shape))
    if name == "b1":  # one combination slot: the artifact events at -inf
        inputs[2:6] = [x[:, :, :1] for x in inputs[2:5]] + [inputs[5][:, :1]]
    else:
        assert inputs[2].shape[2] > 1
    if name in ("tumor_normal", "trio"):
        # every branch gated off at one locus, and at another every other
        # one (events with all their branches gated off)
        inputs[6] = inputs[6].copy()
        inputs[6][1, :] = False
        inputs[6][2, ::2] = False
    return engine, jax_engine, inputs, pj


CASES = ("tumor_normal", "l2fc", "trio", "single", "full_prior", "b1", "false_event", "g2")


@pytest.mark.parametrize("name", CASES)
def test_engine_matches_jax(name):
    engine, jax_engine, inputs, pj = _case(name)
    h0, t0 = asm.assemble_head.launches, asm.assemble_tail.launches
    got = engine.run(*inputs, ln_prior_joint=pj,
                     ln_prior_idx=None if pj is None else np.arange(len(pj)))
    # the CPU takes the plain versions
    assert (asm.assemble_head.launches, asm.assemble_tail.launches) == (h0, t0)
    want = {k: np.asarray(v) for k, v in jax_engine.run(*inputs, ln_prior_joint=pj).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    # a locus with every branch gated off is NaN in both engines' joint
    nan = np.isnan(want["joint"])
    assert np.array_equal(np.isnan(got["joint"]), nan)
    rows = ~nan.any(axis=1)
    assert rows.sum() >= len(rows) - 1
    problems, _ = compare_outputs({k: v[rows] for k, v in want.items()},
                                  {k: v[rows] for k, v in got.items()},
                                  grid_values=engine.grid.values)
    assert not problems, problems
    if name == "b1":
        art = np.asarray(engine.event_is_artifact)
        assert np.isneginf(got["joint"][:, art]).all()
    if name == "false_event":
        empty = [not ix for ix in engine.event_branch_idx]
        assert np.isneginf(got["joint"][:, empty]).all()


def _head_args(L=4, seed=0):
    _, engine = tumor_normal_engine(device="cpu")
    rng = np.random.default_rng(seed)
    NB = engine.n_branches
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32))  # noqa: E731
    bv = t(rng.normal(-20.0, 5.0, (L, 3, NB)))
    gates = torch.ones((L, NB), dtype=torch.bool)
    w = [t(rng.normal(-3.0, 1.0, (L, NB, v.size))) for v in engine.values_s]
    return engine, bv, gates, w


def test_wrappers_check_their_inputs():
    engine, bv, gates, w = _head_args()
    tab = engine._assemble_t
    L, NB = bv.shape[0], bv.shape[2]
    h0, t0 = asm.assemble_head.launches, asm.assemble_tail.launches
    n_art = torch.full((L,), 4.0)
    out = asm.assemble_head(bv, gates, n_art, 4, w, tab)
    assert [tuple(x.shape) for x in out[:5]] == [(L, 9), (L,), (L, 9), (L, 3), (L,)]
    with pytest.raises(TypeError, match="float32"):
        asm.assemble_head(bv.double(), gates, n_art, 4, w, tab)
    with pytest.raises(ValueError, match="rank"):
        asm.assemble_head(bv[0], gates, n_art, 4, w, tab)
    with pytest.raises(ValueError, match="branch_gates"):
        asm.assemble_head(bv, gates.float(), n_art, 4, w, tab)
    with pytest.raises(ValueError, match="branches"):
        asm.assemble_head(bv[:, :, :-1], gates, n_art, 4, w, tab)
    with pytest.raises(ValueError, match=r"w_list\[1\]"):
        asm.assemble_head(bv, gates, n_art, 4, [w[0], w[1][..., :-1]], tab)
    with pytest.raises(ValueError, match="samples"):
        asm.assemble_head(bv, gates, n_art, 4, w[:1], tab)
    with pytest.raises(ValueError, match="unsupported device"):
        asm.assemble_head(bv.to("meta"), gates.to("meta"), None, 4, [x.to("meta") for x in w],
                          tab)
    marginal = out[1]
    d_own = [torch.zeros((L, 1, NB, v.size)) for v in engine.values_s]
    U0 = [torch.zeros((L, 1, NB))]
    af, dph, idx = asm.assemble_tail(d_own, U0, [0, 0], marginal, tab)
    assert tuple(af.shape) == (L, 2) and dph.dtype == idx.dtype == torch.int16
    assert idx.shape[1] == sum(min(AFD_TOP_K, v.size) for v in engine.values_s)
    with pytest.raises(ValueError, match=r"d_own\[1\]"):
        asm.assemble_tail([d_own[0], d_own[1][..., :-1]], U0, [0, 0], marginal, tab)
    with pytest.raises(ValueError, match="component"):
        asm.assemble_tail(d_own, U0, [0, 1], marginal, tab)
    with pytest.raises(ValueError, match="U0"):
        asm.assemble_tail(d_own, [U0[0][..., :-1]], [0, 0], marginal, tab)
    with pytest.raises(TypeError, match="float32"):
        asm.assemble_tail(d_own, U0, [0, 0], marginal.double(), tab)
    assert (asm.assemble_head.launches, asm.assemble_tail.launches) == (h0, t0)
