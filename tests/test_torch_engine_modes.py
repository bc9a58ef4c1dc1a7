"""The posterior engine's l2fc, cyclic-contamination and --full-prior modes:
the port (ops/posterior.py) against the JAX package on the CPU.

Each case builds the same engine in both packages (from events, or from a
scenario), feeds both the same numpy-seeded inputs (bench_utils.synth_batch
for every sample, a random joint prior for --full-prior) and compares the
host outputs with compare.compare_outputs: posteriors, marginal and joint
within 1e-4 * max(1, |x|) with the same finiteness; af within 1e-4 or on the
reference's flat density peak; densities_dphred +-1 deci-PHRED;
best_nonartifact, map_slot and n_obs exactly.  Each case runs on the port's
own engine and on one rebuilt by ``from_state(engine_state_from_jax(...))``.

The cases mirror the JAX package's own (tests/test_posterior.py,
tests/test_scope_lifts.py) plus the orientation and placement variants that
a transposed mask or pair factor would break, and l2fc masks that exclude
every grid pair (the branch must be -inf, never NaN)."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from varlociraptor_tpu_torch import bench_utils as tbu
from varlociraptor_tpu_torch.bench_utils import TRIO_SCENARIO
from varlociraptor_tpu_torch.compare import compare_outputs
from varlociraptor_tpu_torch.convert import engine_state_from_jax
from varlociraptor_tpu_torch.ops.posterior import PosteriorEngine

CONTAM_TRIO_SCENARIO = {
    "samples": {
        "normal": {"universe": "[0.0,1.0]", "ploidy": 2, "resolution": 0.1},
        "tumor": {
            "universe": "[0.0,1.0]",
            "resolution": 0.1,
            "contamination": {"by": "normal", "fraction": 0.25},
        },
        "relapse": {
            "universe": "[0.0,1.0]",
            "resolution": 0.1,
            "contamination": {"by": "normal", "fraction": 0.4},
        },
    },
    "species": {"heterozygosity": 0.001},
    "events": {
        "somatic": "tumor:]0.0,1.0] & normal:0.0 & relapse:]0.0,1.0]",
        "germline": "tumor:]0.0,1.0] & normal:0.5 & relapse:]0.0,1.0]",
    },
}


def _four_sample_scenario(contamination):
    """Four samples at resolution 0.25 (tests/test_scope_lifts.py:216,275)
    with ``contamination`` = {sample: (by, fraction)}."""
    samples = {}
    for name in ("s0", "s1", "s2", "s3"):
        s = {"universe": "[0.0,1.0]", "resolution": 0.25}
        if name in contamination:
            by, frac = contamination[name]
            s["contamination"] = {"by": by, "fraction": frac}
        else:
            s["ploidy"] = 2
        samples[name] = s
    return {
        "samples": samples,
        "species": {"heterozygosity": 0.001},
        "events": {
            "present": "s0:]0.0,1.0] | s1:]0.0,1.0] | s2:]0.0,1.0] | s3:]0.0,1.0]",
        },
    }


def _mods(pkg):
    if pkg == "jax":
        from varlociraptor_tpu.grammar import compiler, scenario
        from varlociraptor_tpu.ops import event_program, grid, posterior
        from varlociraptor_tpu.ops.biases import FULL_COMBOS_DEFAULT
    else:
        from varlociraptor_tpu_torch.grammar import compiler, scenario
        from varlociraptor_tpu_torch.ops import event_program, grid, posterior
        from varlociraptor_tpu_torch.ops.biases import FULL_COMBOS_DEFAULT
    return SimpleNamespace(
        ep=event_program, AFGrid=grid.AFGrid, post=posterior,
        Scenario=scenario.Scenario, compile=compiler.compile_scenario_events,
        n_art=len(FULL_COMBOS_DEFAULT) - 1, pkg=pkg,
    )


def _make(m, events, grid, samples, **kw):
    if m.pkg == "torch":
        kw["device"] = "cpu"
    return m.post.PosteriorEngine(
        events, grid, samples, n_artifact_combos=m.n_art, **kw
    )


def _range_event(m, name, n, lfcs=()):
    """Every sample in ]0, 1], with l2fc constraints ``lfcs``."""
    return m.ep.EventSpec(
        name=name,
        branches=(m.ep.BranchSpec(
            spectra=tuple(
                m.ep.SpectrumSpec.from_range(0.0, 1.0, left_exclusive=True)
                for _ in range(n)
            ),
            lfcs=tuple(m.ep.LfcConstraint(*c) for c in lfcs),
        ),),
    )


def _events_engine(samples, lfcs=(), res=0.01, all_uniform=False):
    """Engine builder over events [absent, present(+lfcs)]; ``samples`` =
    [(name, contaminated_by, fraction)]."""

    def build(m):
        n = len(samples)
        events = [m.ep.absent_event(n), _range_event(m, "present", n, lfcs)]
        cfg = [
            m.post.SampleConfig(name, contaminated_by=by, contamination_fraction=f)
            for name, by, f in samples
        ]
        grid = m.AFGrid.build(res, extra_points=[0.5])
        return _make(m, events, grid, cfg, resolution=res,
                     all_uniform_prior=all_uniform)

    return build


def _scenario_engine(scenario, res, all_uniform=False):
    def build(m):
        sc = m.Scenario(scenario)
        events, grid_points = m.compile(sc, "chr1")
        grid = m.AFGrid.build(res, extra_points=grid_points)
        cfg = []
        for name in sc.sample_names:
            s = sc.samples[name]
            if s.contamination is not None:
                cfg.append(m.post.SampleConfig(
                    name, contaminated_by=sc.idx(s.contamination.by),
                    contamination_fraction=s.contamination.fraction,
                    resolution=s.resolution,
                ))
            else:
                cfg.append(m.post.SampleConfig(name, resolution=s.resolution))
        return _make(m, events, grid, cfg, resolution=res,
                     all_uniform_prior=all_uniform)

    return build


def _singles(n):
    return [(f"s{i}", None, 0.0) for i in range(n)]


STAR = [("s0", 2, 0.1), ("s1", 2, 0.2), ("s2", None, 0.0)]
CYCLE3 = [("a", 1, 0.1), ("b", 2, 0.1), ("c", 0, 0.1)]
# cycle 0 -> 1 -> 2 -> 0 with the tree node 3 -> 1 (test_posterior.py:426)
RHO4 = [("s0", 1, 0.1), ("s1", 2, 0.2), ("s2", 0, 0.3), ("s3", 1, 0.15)]
# (the full-prior l2fc cases use no "==" constraint on the two tail axes: it
# would force g_x == g_y and hide a mask row placed on the wrong tail axis)
# l2fc that no grid pair satisfies (log2 ratios are finite or +-inf)
NEVER = ("==", 50.0)

# name -> (engine builder, full prior?)
CASES = {
    # l2fc under the absent-only split
    "chained_l2fc": (_events_engine(
        _singles(3), [(0, 1, "==", 0.0), (1, 2, "<=", 1.0)]), False),
    "star_l2fc": (_events_engine(STAR, [(1, 0, ">", 1.0)]), False),
    "cyclic_l2fc": (_events_engine(
        _singles(3), [(0, 1, "<=", 1.0), (1, 2, "<=", 1.0), (2, 0, "<=", 1.0)]),
        False),
    "chained_l2fc_contaminated": (_events_engine(
        STAR, [(0, 1, "==", 0.0), (1, 2, "<=", 1.0)]), False),
    "l2fc_own_contaminant": (_events_engine(STAR, [(2, 0, "<=", 1.0)]), False),
    "l2fc_scenario": (_scenario_engine(tbu.L2FC_SCENARIO, 0.05), False),
    "l2fc_excludes_all": (_events_engine(_singles(2), [(0, 1, *NEVER)]), False),
    "star_l2fc_excludes_all": (_events_engine(STAR, [(0, 1, *NEVER)]), False),
    # contamination cycles of length >= 3
    "cycle3": (_events_engine(CYCLE3), False),
    "rho4": (_events_engine(RHO4, res=0.1), False),
    "cycle3_l2fc": (_events_engine(CYCLE3, [(0, 2, ">=", 0.0)], res=0.1), False),
    # --full-prior
    "fp_single": (_events_engine(_singles(1), all_uniform=True), True),
    "fp_mutual": (_events_engine(
        [("a", 1, 0.1), ("b", 0, 0.05)], all_uniform=True), True),
    "fp_l2fc": (_events_engine(
        _singles(2), [(0, 1, "==", 0.0)], all_uniform=True), True),
    "fp_pair_swapped_l2fc": (_events_engine(
        [("n", None, 0.0), ("t", 0, 0.25)], [(1, 0, ">", 0.0)]), True),
    "fp_s4": (_events_engine(_singles(4), res=0.1, all_uniform=True), True),
    "fp_s4_l2fc": (_events_engine(
        _singles(4), [(0, 1, "<=", 1.0), (3, 0, ">", -1.0), (2, 3, "<=", 1.0),
                      (1, 2, ">=", 0.0)], res=0.1), True),
    "fp_trio": (_scenario_engine(TRIO_SCENARIO, 0.1), True),
    "fp_trio_l2fc": (_events_engine(
        _singles(3), [(2, 0, "<=", 1.0), (1, 2, ">=", 0.0)], res=0.1), True),
    "fp_contam_trio": (_scenario_engine(CONTAM_TRIO_SCENARIO, 0.1), True),
    "fp_contam4_placement": (_scenario_engine(_four_sample_scenario(
        {"s1": ("s0", 0.3), "s2": ("s3", 0.2)}), 0.25), True),
    "fp_lead_by_tail": (_scenario_engine(_four_sample_scenario(
        {"s1": ("s3", 0.35)}), 0.25), True),
    "fp_cycle3": (_events_engine(CYCLE3, res=0.1), True),
}

N_LOCI, DEPTH = 6, 16
_cache = {}


def _inputs(engine, seed):
    inputs = list(tbu.engine_inputs(engine, n_loci=N_LOCI, depth=DEPTH, seed=seed))
    rng = np.random.default_rng(seed + 100)
    # gate a branch off at one locus, as the SNV gates do
    inputs[6][1, -1] = False
    return inputs, rng


def _joint_prior(engine, rng):
    G = tuple(len(v) for v in engine.values_s)
    return np.log(rng.uniform(0.05, 1.0, (N_LOCI,) + G)).astype(np.float32)


def _reference(case):
    """(JAX engine, inputs, joint prior or None, JAX outputs), cached per
    case across the two builds."""
    if case not in _cache:
        build, full_prior = CASES[case]
        je = build(_mods("jax"))
        inputs, rng = _inputs(je, seed=sorted(CASES).index(case))
        pj = _joint_prior(je, rng) if full_prior else None
        _cache[case] = (je, inputs, pj, je.run(*inputs, ln_prior_joint=pj))
    return _cache[case]


def _check(ref, got, engine):
    problems, info = compare_outputs(ref, got, grid_values=engine.grid.values)
    assert not problems, problems
    if info["topk_swaps"]:
        print("AFD top-K swaps between equal-density points:", info["topk_swaps"])
    if info["af_flat"]:
        print("MAP AF on a flat density peak:", info["af_flat"])


@pytest.mark.parametrize("build", ["own", "from_state"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_mode_matches_jax(case, build):
    je, inputs, pj, ref = _reference(case)
    if build == "own":
        te = CASES[case][0](_mods("torch"))
    else:
        te = PosteriorEngine.from_state(engine_state_from_jax(je), device="cpu")
    # the port takes each locus's table as a row of the tables, by index
    got = te.run(*inputs, ln_prior_joint=pj,
                 ln_prior_idx=None if pj is None else np.arange(len(pj)))
    assert set(ref) == set(got)
    for k, v in got.items():
        assert not np.isnan(np.asarray(v, dtype=np.float64)).any(), k
    _check(ref, got, te)
    if case.endswith("excludes_all"):
        # the constrained event can hold nowhere: -inf, not NaN
        assert te.branch_lfc_masks and not any(
            m.any() for lst in te.branch_lfc_masks.values() for _, _, m in lst
        )
        assert np.all(got["posteriors"][:, 1] == -np.inf)
        assert np.isfinite(got["marginal"]).all()


def test_engine_mode_masks_canonical():
    """Masks are stored (min, max) and AND-ed per pair: l2fc(1, 0) > 1 is
    l2fc(0, 1) < -1, and two constraints on one pair give one mask."""
    m = _mods("torch")
    pair = _events_engine(_singles(2), [(1, 0, ">", 1.0), (0, 1, "<", -1.0)])(m)
    (bi, [(a, b, mask)]), = pair.branch_lfc_masks.items()
    v = pair.values_s[0].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.log2(v[:, None] / v[None, :]) < -1.0
    want[0, 1:] = True  # vaf_a == 0 < vaf_b: l2fc = -inf
    want[:, 0] = False  # vaf_b == 0: +inf, or 0 at (0, 0)
    assert (a, b) == (0, 1) and np.array_equal(mask, want)


def _random_factors(engine, seed, L=3, B=2):
    """Random [L,NB,G_i] weights (-inf off each branch's support) and
    [L,B,G_i,G_parent] pair factors, numpy."""
    rng = np.random.default_rng(seed)
    NB, S = engine.n_branches, engine.n_samples
    G = [len(engine.values_s[i]) for i in range(S)]
    w = []
    for i in range(S):
        wv = rng.normal(size=(L, NB, G[i])).astype(np.float32)
        cls, masks = engine.support_classes[i]
        for n in range(NB):
            wv[:, n, ~masks[cls[n]]] = -np.inf
        w.append(wv)
    F = {
        si: rng.normal(size=(L, B, G[si], G[by])).astype(np.float32)
        for si, by, _ in engine.pairs
    }
    ll = {
        si: rng.normal(size=(L, B, G[si])).astype(np.float32)
        for si in range(S) if engine.parent[si] is None
    }
    return w, F, ll


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], ref[~fin])
    err = np.abs(got[fin] - ref[fin]) / np.maximum(1.0, np.abs(ref[fin]))
    assert err.max(initial=0.0) <= tol, err.max()


@pytest.mark.parametrize("keep", [None, 0, 1, 2, 3])
def test_cyclic_component_matches_jax(keep):
    """The rho-shaped component (cycle 0 -> 1 -> 2 -> 0, tree node 3 -> 1)
    reduced with and without each kept axis, on random factors
    (tests/test_posterior.py:426)."""
    import jax.numpy as jnp

    je = _events_engine(RHO4, res=0.1)(_mods("jax"))
    te = _events_engine(RHO4, res=0.1)(_mods("torch"))
    assert te._component_cycle([0, 1, 2, 3]) == je._component_cycle([0, 1, 2, 3])
    w, F, _ = _random_factors(je, seed=5)
    ref = je._component_reduce(
        [0, 1, 2, 3], {}, {k: jnp.asarray(v) for k, v in F.items()},
        [jnp.asarray(x) for x in w], keep=keep,
    )
    got = te._component_reduce(
        [0, 1, 2, 3], {}, {k: torch.as_tensor(v) for k, v in F.items()},
        [torch.as_tensor(x) for x in w], keep=keep,
    )
    _close(got, ref)


@pytest.mark.parametrize("case", ["chained_l2fc", "cyclic_l2fc", "chained_l2fc_contaminated"])
def test_lfc_group_joint_matches_jax(case):
    """The generic l2fc enumeration on random factors against the JAX
    package's, and against the tree eliminator where both apply
    (tests/test_posterior.py:530)."""
    import jax.numpy as jnp

    je = CASES[case][0](_mods("jax"))
    te = CASES[case][0](_mods("torch"))
    w, F, ll = _random_factors(je, seed=9)
    comp_of = {s: tuple(c) for c in je.components for s in c}
    (bi, jgroup), = je.branch_lfc_masks.items()
    tgroup = te._lfc_t[bi]
    nodes = sorted({s for (a, b, _) in jgroup for s in (a, b)})
    jargs = ({k: jnp.asarray(v) for k, v in ll.items()},
             {k: jnp.asarray(v) for k, v in F.items()}, [jnp.asarray(x) for x in w])
    targs = ({k: torch.as_tensor(v) for k, v in ll.items()},
             {k: torch.as_tensor(v) for k, v in F.items()}, [torch.as_tensor(x) for x in w])
    t_ref, z_ref = je._lfc_group_joint(jgroup, nodes, *jargs, bi, comp_of)
    t_got, z_got = te._lfc_group_joint(tgroup, nodes, *targs, bi, comp_of)
    _close(t_got, t_ref)
    _close(z_got, z_ref)
    if case == "chained_l2fc":
        t_tree, z_tree = te._lfc_tree_eliminate(tgroup, nodes, targs[0], targs[2], bi)
        _close(t_tree, t_got)
        _close(z_tree, z_got)


def test_lfc_cluster_guard():
    """A constraint cluster over more than 2,000,000 joint cells is refused
    with the JAX package's message."""
    te = _events_engine(STAR, [(0, 1, "==", 0.0), (1, 2, "<=", 1.0)], res=0.005)(
        _mods("torch"))
    inputs, _ = _inputs(te, seed=0)
    with pytest.raises(ValueError, match="joint grid of .* cells over samples"):
        te.run(*[x[:1] for x in inputs])


def test_logaddexp_carry_at_minus_inf():
    """The loops' carry: logaddexp(-inf, -inf) is -inf, not NaN."""
    ninf = torch.full((3,), -math.inf)
    assert torch.equal(torch.logaddexp(ninf, ninf), ninf)
