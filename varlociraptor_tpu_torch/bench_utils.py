"""Synthetic workload generation + engine setup (the port's twin of
``varlociraptor_tpu/bench_utils.py``).  Inputs come from numpy
``default_rng(seed)`` exactly as in the reference, so both packages see the
same batch for the same seed."""

from __future__ import annotations

import math

import numpy as np
import torch

from .evidence.observation import F, N_FEATURES
from .grammar.compiler import compile_scenario_events
from .grammar.scenario import tumor_normal_scenario
from .ops.biases import FULL_COMBOS_DEFAULT
from .ops.grid import AFGrid
from .ops.posterior import PosteriorEngine, SampleConfig


def synth_batch(n_loci=256, n_samples=2, depth=64, n_combos=9, seed=0):
    """Random but realistic observation tensors for a tumor/normal batch."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((n_loci, n_samples, depth, N_FEATURES), dtype=np.float32)
    mask = rng.random((n_loci, n_samples, depth)) < 0.9
    af = rng.random(n_loci) * 0.6
    is_alt = rng.random((n_loci, n_samples, depth)) < af[:, None, None]
    strong = math.log(1 - 1e-4)
    weak = math.log(1e-4)
    feats[..., F["prob_alt"]] = np.where(is_alt, strong, weak)
    feats[..., F["prob_ref"]] = np.where(is_alt, weak, strong)
    feats[..., F["prob_mapping"]] = math.log(1 - 1e-5)
    feats[..., F["prob_mismapping"]] = math.log(1e-5)
    feats[..., F["prob_missed_allele"]] = math.log(0.5)
    feats[..., F["prob_sample_alt"]] = 0.0
    feats[..., F["prob_double_overlap"]] = -np.inf
    feats[..., F["prob_single_overlap"]] = 0.0
    feats[..., F["prob_hit_base"]] = math.log(1.0 / 100)
    feats[..., F["strand"]] = rng.integers(1, 3, (n_loci, n_samples, depth))
    feats[..., F["read_orientation"]] = rng.integers(1, 3, (n_loci, n_samples, depth))
    feats[..., F["homopolymer_indel_len"]] = 127

    bias_alt = np.full((n_loci, n_samples, n_combos, depth), math.log(0.5), np.float32)
    bias_ref = np.full_like(bias_alt, math.log(0.5))
    bias_any = np.full_like(bias_alt, math.log(0.5))
    combo_active = np.zeros((n_loci, n_combos), dtype=bool)
    combo_active[:, 0] = True
    combo_active[:, 1:3] = rng.random((n_loci, 2)) < 0.3
    return feats, mask, bias_alt, bias_ref, bias_any, combo_active


# a mendelian trio at per-sample resolution 0.1 (tests/test_scope_lifts.py's
# TRIO_SCENARIO)
TRIO_SCENARIO = {
    "samples": {
        "mother": {"universe": "[0.0,1.0]", "ploidy": 2, "resolution": 0.1},
        "father": {"universe": "[0.0,1.0]", "ploidy": 2, "resolution": 0.1},
        "child": {
            "universe": "[0.0,1.0]",
            "ploidy": 2,
            "resolution": 0.1,
            "inheritance": {"mendelian": {"from": ["mother", "father"]}},
        },
    },
    "species": {"heterozygosity": 0.001, "germline-mutation-rate": 1e-3},
    "events": {
        "germline": "mother:0.5 & father:0.0 & child:0.5",
        "denovo": "mother:0.0 & father:0.0 & child:0.5",
    },
}

# a child and both parents, each of ploidy 2 with a somatic rate and the
# default resolution 0.01 (101^3 joint cells), the child mendelian from both:
# de novo, mosaic de novo and inherited events under --full-prior
TRIO_DENOVO_SCENARIO = {
    "species": {"heterozygosity": 0.001, "germline-mutation-rate": 0.001},
    "samples": {
        "mother": {"ploidy": 2, "somatic-effective-mutation-rate": 1e-06},
        "father": {"ploidy": 2, "somatic-effective-mutation-rate": 1e-06},
        "child": {"ploidy": 2, "somatic-effective-mutation-rate": 1e-06,
                  "inheritance": {"mendelian": {"from": ["mother", "father"]}}},
    },
    "events": {
        "denovo": "mother:0.0 & father:0.0 & child:0.5",
        "denovo_mosaic": "mother:0.0 & father:0.0 & child:]0.0,0.5[",
        "inherited": "child:]0.0,1.0] & (mother:0.5 | mother:1.0 | father:0.5 | father:1.0)",
    },
}

# tumor / relapse / normal with tumor and relapse contaminated by normal (the
# shape of tests/test_scope_lifts.py's CONTAM_TRIO_SCENARIO) at per-sample
# resolution 0.01, with disjoint somatic events split by l2fc(relapse, tumor):
# one with two constraints on the pair (their masks are AND-ed) and one
# written as a sample-vs-sample comparison (which desugars to l2fc)
L2FC_SCENARIO = {
    "samples": {
        "normal": {"universe": "[0.0,1.0]", "ploidy": 2, "resolution": 0.01},
        "tumor": {
            "universe": "[0.0,1.0]",
            "resolution": 0.01,
            "contamination": {"by": "normal", "fraction": 0.25},
        },
        "relapse": {
            "universe": "[0.0,1.0]",
            "resolution": 0.01,
            "contamination": {"by": "normal", "fraction": 0.4},
        },
    },
    "species": {"heterozygosity": 0.001},
    "events": {
        "somatic_stable": "tumor:]0.0,1.0] & relapse:]0.0,1.0] & normal:0.0 "
                          "& l2fc(relapse, tumor) >= 0 & l2fc(relapse, tumor) <= 1",
        "somatic_expanded": "tumor:]0.0,1.0] & relapse:]0.0,1.0] & normal:0.0 "
                            "& l2fc(relapse, tumor) > 1",
        "somatic_receding": "tumor > relapse & normal:0.0",
        "germline": "tumor:]0.0,1.0] & normal:0.5 & relapse:]0.0,1.0]",
    },
}


def scenario_engine(scenario, resolution=0.01, device="cuda",
                    all_uniform_prior=True):
    """(scenario, engine) of a ``Scenario`` (or its dict) on chr1, with the
    call stage's sample configuration."""
    from .grammar.scenario import Scenario

    if isinstance(scenario, dict):
        scenario = Scenario(scenario)
    events, grid_points = compile_scenario_events(scenario, "chr1")
    grid = AFGrid.build(resolution, extra_points=grid_points)
    samples = []
    for name in scenario.sample_names:
        s = scenario.samples[name]
        if s.contamination is not None:
            samples.append(
                SampleConfig(
                    name,
                    contaminated_by=scenario.idx(s.contamination.by),
                    contamination_fraction=s.contamination.fraction,
                    resolution=s.resolution,
                )
            )
        else:
            samples.append(SampleConfig(name, resolution=s.resolution))
    engine = PosteriorEngine(
        events,
        grid,
        samples,
        resolution=resolution,
        all_uniform_prior=all_uniform_prior,
        n_artifact_combos=len(FULL_COMBOS_DEFAULT) - 1,
        device=device,
    )
    return scenario, engine


def tumor_normal_engine(resolution=0.01, purity=0.75, device="cuda"):
    """(scenario, engine) of the headline tumor-normal configuration."""
    return scenario_engine(tumor_normal_scenario(purity), resolution, device)


def l2fc_engine(device="cuda"):
    """Engine of :data:`L2FC_SCENARIO` at resolution 0.01 with the
    absent-only prior split (the star-component l2fc path)."""
    return scenario_engine(L2FC_SCENARIO, 0.01, device,
                           all_uniform_prior=False)[1]


def cyclic_engine(device="cuda"):
    """Engine of a three-sample contamination cycle (a by b, b by c, c by
    a, fraction 0.2 each) at resolution 0.01 with the events absent and
    present (every sample in ]0, 1])."""
    from .ops.event_program import BranchSpec, EventSpec, SpectrumSpec, absent_event

    present = EventSpec(
        name="present",
        branches=(BranchSpec(spectra=tuple(
            SpectrumSpec.from_range(0.0, 1.0, left_exclusive=True)
            for _ in range(3)
        )),),
    )
    samples = [
        SampleConfig(name, contaminated_by=(i + 1) % 3,
                     contamination_fraction=0.2)
        for i, name in enumerate("abc")
    ]
    grid = AFGrid.build(0.01, extra_points=[0.5])
    return PosteriorEngine(
        [absent_event(3), present], grid, samples, resolution=0.01,
        n_artifact_combos=len(FULL_COMBOS_DEFAULT) - 1, device=device,
    )


def rho_engine(device="cuda"):
    """Engine of a contamination cycle with a tree node (a by b, b by c, c
    by a, fraction 0.2 each, and d by b at 0.15) at resolution 0.01 with the
    events absent and present: the cyclic reducer eliminates d into b, and
    walks b down to d where d's grid is kept."""
    from .ops.event_program import BranchSpec, EventSpec, SpectrumSpec, absent_event

    present = EventSpec(
        name="present",
        branches=(BranchSpec(spectra=tuple(
            SpectrumSpec.from_range(0.0, 1.0, left_exclusive=True)
            for _ in range(4)
        )),),
    )
    samples = [
        SampleConfig(name, contaminated_by=by, contamination_fraction=frac)
        for name, by, frac in (("a", 1, 0.2), ("b", 2, 0.2), ("c", 0, 0.2), ("d", 1, 0.15))
    ]
    grid = AFGrid.build(0.01, extra_points=[0.5])
    return PosteriorEngine(
        [absent_event(4), present], grid, samples, resolution=0.01,
        n_artifact_combos=len(FULL_COMBOS_DEFAULT) - 1, device=device,
    )


def full_prior_table(scenario, engine):
    """The --full-prior joint prior of an SNV on chr1 on ``engine``'s
    per-sample active subgrids, as the call stage builds it, and the host
    seconds it took."""
    import time

    from .calling.call import CallOptions, GenericCaller
    from .calling.variants import VariantInfo

    caller = GenericCaller(
        scenario, CallOptions(full_prior=True, resolution=engine.resolution),
        device=engine.device,
    )
    t0 = time.perf_counter()
    _, table = caller._full_prior_table(
        VariantInfo(kind="snv", chrom="chr1", pos=0, ref_allele="A",
                    alt_allele="T"),
        caller._prior_for("chr1", "snv"),
        engine.values_s,
    )
    return table, time.perf_counter() - t0


def engine_inputs(engine, n_loci=256, depth=64, seed=0):
    from .ops.biases import compact_combos

    feats, mask, ba, br, by, active = synth_batch(
        n_loci=n_loci, n_samples=engine.n_samples, depth=depth,
        n_combos=len(FULL_COMBOS_DEFAULT), seed=seed,
    )
    # same combo-axis compaction the caller applies (call.py)
    ba, br, by, active, _ = compact_combos(ba, br, by, active)
    branch_gates = np.ones((n_loci, engine.n_branches), dtype=bool)
    ln_prior_absent = np.full(n_loci, math.log(0.5), dtype=np.float32)
    return feats, mask, ba, br, by, active, branch_gates, ln_prior_absent


def k1_engine_rows(engine, n_loci, depth, seed, which):
    """Folded K1 inputs (a, r, m, psa, nu, kappa) of one engine call's
    sample on the engine's device: ``which`` = "pair" (tumor, unique
    (nu, kappa) classes) or "grid" (normal, its own subgrid)."""
    import torch

    from .ops.likelihood import _read_terms

    feats, mask, ba, br, by, *_ = engine_inputs(engine, n_loci=n_loci, depth=depth, seed=seed)
    dev = engine.device
    if which == "pair":
        si = engine.pairs[0][0]
        nu, kappa, _ = engine._pair_t[si]
    else:
        si = engine.root_samples[0]
        nu = engine._values_t[si]
        kappa = (nu == 1.0).to(torch.float32)
    t = lambda x: torch.as_tensor(x[:, si]).to(dev)  # noqa: E731
    a, r, m, c, psa = _read_terms(t(feats), t(ba), t(br), t(by))
    mk = t(mask)[:, None, :]
    L, B, D = a.shape
    fold = lambda x, v: torch.where(mk, x, v).reshape(L * B, D).contiguous()  # noqa: E731
    return (fold(a, 1.0), fold(r, 1.0), fold(m, 0.0),
            psa.expand(L, B, D).reshape(L * B, D).contiguous(),
            nu.contiguous(), kappa.contiguous())


# edge cases of K1's arithmetic (see k1_edge_rows)
K1_EDGE_CASES = ("d3", "d256", "underflow", "denormal_and_zero", "all_masked", "u1",
                 "u_ragged")


def k1_edge_rows(name, seed=0):
    """Folded K1 inputs (a, r, m, psa, nu, kappa), numpy float32, of one
    edge case: a fifth of the reads masked to (1, 1, 0), one class at
    nu = kappa = 1 and one at nu = 0, and

    * ``d3`` / ``d256``: 3 reads (not a multiple of the reads per log) and
      256 reads (four staged chunks);
    * ``underflow``: half the reads at a = 1, r = m = 1e-35 and classes at
      or near w = 0, so the terms sit near the bottom of the normal range;
    * ``denormal_and_zero``: 128 reads; in the second 64 of the first 32
      rows, r = m = 1e-40 (denormal terms) or r = m = 0 (t = 0 where w = 0:
      -inf), so those row tiles take that chunk on the per-cell path;
    * ``all_masked``: every other row all masked (a sum of exactly 0);
    * ``u1`` / ``u_ragged``: one class, and 129 classes (not a multiple of
      the class tile)."""
    rng = np.random.default_rng(seed)
    N, D, U = {"d3": (100, 3, 37), "d256": (512, 256, 711), "underflow": (64, 64, 129),
               "denormal_and_zero": (64, 128, 37), "all_masked": (64, 64, 711),
               "u1": (300, 64, 1), "u_ragged": (200, 40, 129)}[name]
    a = rng.uniform(0.01, 1.0, (N, D))
    r = rng.uniform(0.01, 1.0, (N, D))
    m = rng.uniform(0.0, 0.1, (N, D))
    psa = rng.uniform(0.0, 1.0, (N, D))
    nu = rng.uniform(0.0, 1.0, U)
    kappa = np.zeros(U)
    if name == "underflow":
        tiny = rng.random((N, D)) < 0.5
        a[tiny], r[tiny], m[tiny] = 1.0, 1e-35, 1e-35
        nu[: U // 2] = rng.uniform(0.0, 1e-6, U // 2)
    if name == "denormal_and_zero":
        sub = np.zeros((N, D), bool)
        sub[:32, 64:] = True
        zero = sub & (rng.random((N, D)) < 0.1)
        den = sub & ~zero & (rng.random((N, D)) < 0.4)
        a[den | zero] = 1.0
        r[den], m[den] = 1e-40, 1e-40
        r[zero], m[zero] = 0.0, 0.0
        nu[1:4] = [0.0, 1e-30, 1e-3]
    masked = rng.random((N, D)) < 0.2
    if name == "all_masked":
        masked[::2] = True
    a[masked], r[masked], m[masked] = 1.0, 1.0, 0.0
    nu[0], kappa[0] = 1.0, 1.0
    if U > 1:
        nu[-1] = 0.0
    return tuple(np.ascontiguousarray(x, dtype=np.float32) for x in (a, r, m, psa, nu, kappa))


# cases of the engine's grid contraction (see lse_contract_args)
LSE_CONTRACT_CASES = ("unit", "map", "afd_swapped", "neg_inf", "no_class", "nb_gt_k",
                      "large")
# the tumor-normal call's classes: the tumor's (Gv 101; the absent branch
# on the zero point, eight on the whole grid) and the normal's (Gv 15)
_TUMOR_CLASSES = ([0] + [1] * 8, [[0]], None)
_NORMAL_CLASSES = ([0, 0, 1, 2, 3, 0, 1, 2, 3], [list(range(10)), [10], [12], [14]], None)


def lse_contract_args(name, device, L=None, seed=0):
    """(F, S, class table) of one case of ``ops.lse_contract``, on ``device``:
    F [L, B, Gv, Gu] ~ N(-20, 4) and S [L, B, NB, Gv] ~ N(-5, 2) float32, as
    the engine passes them:

    * ``unit``: the call's grid elimination, F [L, 8, 101, 15] and S
      expanded over B from [L, 1, 9, 101], the tumor's classes (L 1024);
    * ``map``: F [L, 1, 101, 15] a slice of a B = 8 slab, S [L, 1, 9, 101];
    * ``afd_swapped``: F the swapped view of [L, 1, 101, 15], S [L, 1, 9,
      15], the normal's classes (one of ten points, three of one);
    * ``neg_inf``: F rows (l, b) and class columns all -inf, S rows all -inf
      and a fifth of S -inf; a class with one grid point;
    * ``no_class``: two branches in no class;
    * ``nb_gt_k``: 21 branches in 3 classes, one of 13 branches (more than
      a group) and masks with holes;
    * ``large``: Gv = Gu = 1001, more than a block's shared memory."""
    from .ops.lse_contract import class_table

    rng = np.random.default_rng(seed)
    B, Gv, Gu, classes = {
        "unit": (8, 101, 15, _TUMOR_CLASSES), "map": (1, 101, 15, _TUMOR_CLASSES),
        "afd_swapped": (1, 15, 101, _NORMAL_CLASSES),
        "neg_inf": (3, 37, 20, ([0, 1, 1, 2, 0], [[0, 5, 6, 7], [3], None], None)),
        "no_class": (2, 33, 9, ([0, -1, 1, 0, -1, 1], [[1, 2, 3], None], None)),
        "nb_gt_k": (2, 40, 24, ([0] * 13 + [1] * 5 + [2] * 3, None, "holes")),
        "large": (1, 1001, 1001, ([0, 1, 1, 0, 1], [list(range(100, 900)), None], None)),
    }[name]
    L = L or {"unit": 1024, "map": 1024, "afd_swapped": 1024, "large": 2}.get(name, 64)
    cls, pts, holes = classes
    NB, K = len(cls), max(cls) + 1
    masks = np.ones((K, Gv), bool)
    for k in range(K):
        if holes:
            masks[k] = rng.random(Gv) < 0.6
        elif pts and k < len(pts) and pts[k] is not None:
            masks[k] = False
            masks[k, pts[k]] = True
    f = rng.normal(-20.0, 4.0, (L, B, Gv, Gu))
    s = rng.normal(-5.0, 2.0, (L, 1 if name == "unit" else B, NB, Gv))
    if name == "neg_inf":
        f[rng.random((L, B)) < 0.1] = -np.inf
        f[:, :, :, 3][:, :, masks[0]] = -np.inf
        s[rng.random(s.shape[:3]) < 0.1] = -np.inf
        s[rng.random(s.shape) < 0.2] = -np.inf

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)

    if name == "map":
        F = t(np.concatenate([f, rng.normal(-20.0, 4.0, (L, 7, Gv, Gu))], axis=1))[:, :1]
    elif name == "afd_swapped":
        F = torch.swapaxes(t(np.swapaxes(f, -1, -2)), -1, -2)
    else:
        F = t(f)
    S = t(s).expand(L, B, NB, Gv)
    return F, S, class_table(np.array(cls), masks, device)


# cases of the engine's star l2fc integral (see lfc_star_args)
LFC_STAR_CASES = ("cell", "f2", "large", "ragged", "gp1", "masked", "neg_inf", "redo")


def lfc_star_args(name, device, L=None, seed=0):
    """(pa, wa, pb, wb, lm, rp) of one case of ``ops.lfc_star``, on
    ``device``: pa [L, B, Ga, Gp] and pb ~ N(-40, 15), the branch weights
    wa [L, Ga] and wb [L, Gb] ~ N(-4, 1) as columns of an [L, 3, G] table,
    rp [L, B, Gp] ~ N(-10, 3), float32, and the log mask lm [Ga, Gb] of
    the l2fc predicate |log2(b / a)| <= 1 on two grids over [0, 1] (both at
    0 included):

    * ``cell``: the ``relapse_l2fc.call3`` cell's branch, [1024, 8, 101,
      101, 11] (L, B, Ga, Gb, Gp);
    * ``f2``: ``chip_smoke.py`` phase (f2)'s, a 101-point normal, [1024, 2,
      101, 101, 101];
    * ``large``: a 1001 x 1001 mask (resolution 0.001), [2, 2, 1001, 1001, 11];
    * ``ragged``: Ga != Gb, neither a multiple of 4, [16, 3, 13, 7, 5];
    * ``gp1``: a one-point parent grid, [16, 3, 10, 11, 1];
    * ``masked``: a fully masked branch (lm all -inf), [8, 2, 10, 11, 4];
    * ``neg_inf``: -inf rows in pa, pb, wa and rp, [16, 3, 17, 17, 5];
    * ``redo``: every pair's peak outside the mask, so that the cheap shift
      of the kernel leaves the sum far below 2^-60, [8, 2, 21, 21, 3]."""
    L0, B, Ga, Gb, Gp = {
        "cell": (1024, 8, 101, 101, 11), "f2": (1024, 2, 101, 101, 101),
        "large": (2, 2, 1001, 1001, 11), "ragged": (16, 3, 13, 7, 5),
        "gp1": (16, 3, 10, 11, 1), "masked": (8, 2, 10, 11, 4),
        "neg_inf": (16, 3, 17, 17, 5), "redo": (8, 2, 21, 21, 3),
    }[name]
    L = L or L0
    rng = np.random.default_rng(seed)
    pa = rng.normal(-40.0, 15.0, (L, B, Ga, Gp))
    pb = rng.normal(-40.0, 15.0, (L, B, Gb, Gp))
    wa = rng.normal(-4.0, 1.0, (L, 3, Ga))
    wb = rng.normal(-4.0, 1.0, (L, 3, Gb))
    rp = rng.normal(-10.0, 3.0, (L, B, Gp))
    va, vb = np.linspace(0.0, 1.0, Ga)[:, None], np.linspace(0.0, 1.0, Gb)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        keep = np.abs(np.log2(vb / va)) <= 1.0
    keep[0, 0] = True
    if name == "masked":
        keep[:] = False
    elif name == "neg_inf":
        pa[rng.random((L, B)) < 0.2] = -np.inf
        pb[:, :, 3][rng.random((L, B)) < 0.2] = -np.inf
        wa[:, 1][rng.random(L) < 0.2] = -np.inf
        rp[rng.random((L, B, Gp)) < 0.3] = -np.inf
        rp[rng.random((L, B)) < 0.1] = -np.inf
    elif name == "redo":
        keep = np.zeros((Ga, Gb), bool)
        keep[5:, 5:] = True
        pa[:, :, :5], pa[:, :, 5:] = 0.0, -100.0
        pb[:, :, :5], pb[:, :, 5:] = 0.0, -100.0

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)

    lm = np.where(keep, 0.0, -np.inf)
    return t(pa), t(wa)[:, 1], t(pb), t(wb)[:, 1], t(lm), t(rp)


# one diploid sample (the engine's one-sample route): het and hom events,
# and one "present" event, which on a grid of resolution 1 leaves the
# sample two grid points (no parabola)
ONE_SAMPLE_SCENARIO = {
    "samples": {"s": {"universe": "[0.0,1.0]", "ploidy": 2}},
    "species": {"heterozygosity": 0.001},
    "events": {"het": "s:0.5", "hom": "s:1.0"},
}
PRESENT_SCENARIO = {
    "samples": {"s": {"universe": "[0.0,1.0]", "ploidy": 2}},
    "species": {"heterozygosity": 0.001},
    "events": {"present": "s:]0.0,1.0]"},
}

# tumor / relapse / normal as the relapse_l2fc.call3 cell deploys it: the
# normal on its coarse ploidy grid, tumor and relapse contaminated by it at
# resolution 0.01, somatic events split three ways by l2fc(relapse, tumor)
RELAPSE_SCENARIO = {
    "samples": {
        "tumor": {"resolution": 0.01, "contamination": {"by": "normal", "fraction": 0.25},
                  "universe": "[0.0,1.0]"},
        "relapse": {"resolution": 0.01, "contamination": {"by": "normal", "fraction": 0.4},
                    "universe": "[0.0,1.0]"},
        "normal": {"resolution": 0.1, "universe": "[0.0,0.5[ | 0.5 | 1.0"},
    },
    "events": {
        "germline_het": "normal:0.5",
        "germline_hom": "normal:1.0",
        "somatic_stable": "normal:0.0 & tumor:]0.0,1.0] & relapse:]0.0,1.0] "
                          "& l2fc(relapse, tumor) >= -1 & l2fc(relapse, tumor) <= 1",
        "somatic_expanded": "normal:0.0 & tumor:]0.0,1.0] & relapse:]0.0,1.0] "
                            "& l2fc(relapse, tumor) > 1",
        "somatic_receded": "normal:0.0 & tumor:]0.0,1.0] & relapse:]0.0,1.0] "
                           "& l2fc(relapse, tumor) < -1",
        "somatic_lost": "normal:0.0 & tumor:]0.0,1.0] & relapse:0.0",
        "somatic_relapse_only": "normal:0.0 & tumor:0.0 & relapse:]0.0,1.0]",
    },
}

# cases of the engine's event and MAP / AFD pass (see assemble_args)
ASSEMBLE_CASES = ("tumor_normal", "relapse_l2fc", "trio", "g1001", "g2", "b1", "ties",
                  "neg_inf", "false_event", "wide")


def false_event_engine(device="cuda"):
    """The tumor-normal engine with two events compiled to False (no
    branch; the second an artifact event) among the others."""
    from .grammar.scenario import Scenario
    from .ops.event_program import EventSpec

    scenario = Scenario(tumor_normal_scenario(0.75).doc)
    events, grid_points = compile_scenario_events(scenario, "chr1")
    events = (events[:2] + [EventSpec("never", ())] + events[2:6]
              + [EventSpec("never_artifact", (), is_artifact=True)] + events[6:])
    samples = [SampleConfig("tumor", contaminated_by=1, contamination_fraction=0.25),
               SampleConfig("normal")]
    return PosteriorEngine(events, AFGrid.build(0.01, extra_points=grid_points), samples,
                           resolution=0.01, all_uniform_prior=True,
                           n_artifact_combos=len(FULL_COMBOS_DEFAULT) - 1, device=device)


def assemble_engine(name, device="cuda"):
    """The engine whose tables a case of :func:`assemble_args` uses."""
    if name == "relapse_l2fc":
        return scenario_engine(RELAPSE_SCENARIO, 0.01, device, all_uniform_prior=False)[1]
    if name == "trio":
        return scenario_engine(TRIO_SCENARIO, 0.1, device)[1]
    if name == "g1001":
        sample = {**ONE_SAMPLE_SCENARIO["samples"]["s"], "resolution": 0.001}
        return scenario_engine({**ONE_SAMPLE_SCENARIO, "samples": {"s": sample}}, 0.001,
                               device)[1]
    if name == "g2":
        return scenario_engine(PRESENT_SCENARIO, 1.0, device)[1]
    if name == "false_event":
        return false_event_engine(device)
    return tumor_normal_engine(0.01, device=device)[1]


def wide_assemble_tables(device, E=13_000, G=(11, 5)):
    """(tables, grid sizes, each sample's component, components) of no
    engine: E events of one branch each (every 997th an artifact event)
    and two samples of G points, each a component of its own.  Past a
    block's default 48 KB of shared memory in both kernels: the head's E
    event values (4 bytes each) and the tail's four warps' NB other-component
    sums."""
    from .ops.assemble import AssembleTables

    values = [torch.linspace(0.0, 1.0, g, dtype=torch.float32, device=device) for g in G]
    backbones = [np.unique(np.round(np.linspace(0, g - 1, min(16, g))).astype(np.int32))
                 for g in G]
    tables = AssembleTables([[e] for e in range(E)], [e % 997 == 3 for e in range(E)],
                            np.arange(E), values, backbones, 16, device)
    return tables, list(G), [0, 1], 2


def assemble_args(name, device, L=None, seed=0):
    """(tables, head, tail) of one case of ``ops.assemble``, on ``device``:
    the engine's ``AssembleTables``; the head's (branch_val [L, B, NB] ~
    N(-30, 10) with whole slots b >= 1 at -inf at half the loci, the gates
    (5% off), n_artifact_active in 0-8 or None, the engine's combination
    count, the weights [L, NB, Gi] ~ N(-3, 1) with 20% at -inf); the tail's
    (d_own [L, 1, NB, Gi] ~ N(-20, 8) with 10% at -inf, a strided view, U0
    a component [L, 1, NB] ~ N(-15, 5), each sample's component, the
    marginal [L] ~ N(-10, 3) with 5% at -inf).  The cases:

    * ``tumor_normal``, ``relapse_l2fc``: the two cells' engines, L 1024, B 8;
    * ``trio``: three components, 11-point grids; ``g1001``: one sample at
      resolution 0.001; ``g2``: one sample on a two-point grid;
    * ``b1``: one combination slot; ``false_event``: two events without a
      branch;
    * ``ties``: integer branch values and densities equal in runs of four
      grid points (exact ties in the events and the top-K);
    * ``neg_inf``: loci whose branch values, weights, densities or marginal
      are -inf throughout, and no n_artifact_active;
    * ``wide``: :func:`wide_assemble_tables`, 13,000 events and branches."""
    if name == "wide":
        tables, G, comp_of, n_comp = wide_assemble_tables(device)
        n_combos = None
    else:
        engine = assemble_engine(name, device)
        tables, G = engine._assemble_t, [len(v) for v in engine.values_s]
        comp_of, n_comp = list(engine._comp_of), len(engine.components)
        n_combos = engine.n_artifact_combos
    L = L or {"tumor_normal": 1024, "relapse_l2fc": 1024, "g1001": 16, "wide": 8}.get(name, 64)
    B = 1 if name == "b1" else 8
    NB = tables.n_branches
    rng = np.random.default_rng(seed)
    bv = rng.normal(-30.0, 10.0, (L, B, NB))
    bv[:, 1:][rng.random((L, B - 1)) < 0.5] = -np.inf
    gates = rng.random((L, NB)) < 0.95
    n_art = rng.integers(0, 9, L).astype(np.float32)
    w = [rng.normal(-3.0, 1.0, (L, NB, g)) for g in G]
    for x in w:
        x[rng.random(x.shape) < 0.2] = -np.inf
    d_own = [rng.normal(-20.0, 8.0, (L, 1, NB, g + 3)) for g in G]
    for x in d_own:
        x[rng.random(x.shape) < 0.1] = -np.inf
    U0 = [rng.normal(-15.0, 5.0, (L, 1, NB)) for _ in range(n_comp)]
    marginal = rng.normal(-10.0, 3.0, L)
    marginal[rng.random(L) < 0.05] = -np.inf
    if name == "ties":
        bv = np.round(bv)
        for x in d_own:
            runs = np.round(rng.normal(-20.0, 3.0, (L, 1, NB, (x.shape[3] + 3) // 4)))
            x[:] = np.repeat(runs, 4, axis=3)[..., : x.shape[3]]
    elif name == "neg_inf":
        bv[::7] = -np.inf
        for x in w:
            x[::5] = -np.inf
        for x in d_own:
            x[::3] = -np.inf
        marginal[::11] = -np.inf
        n_art = None

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    head = (t(bv), t(gates, torch.bool), None if n_art is None else t(n_art),
            n_combos or max(1, B - 1), [t(x) for x in w])
    tail = ([t(x)[..., :g] for x, g in zip(d_own, G)], [t(u) for u in U0], comp_of,
            t(marginal))
    return tables, head, tail


def assemble_mismatches(tables, tail, got_head, ref_head, got_tail, ref_tail, tol):
    """What differs between the kernels' outputs and the plain versions' on
    the same inputs, as ({output: problem}, {output: largest error}), at a
    tolerance ``tol`` x max(1, |x|) on floats with -inf and NaN alike:

    * the joint, marginal, posteriors and combination masses within it;
    * the MAP event equal, or the joint within it at both events but not
      equal (a near tie; an exact tie goes to the lower index on both
      sides); the selections equal where the MAP event is;
    * per sample the top-K indices equal, or the float64 density within it
      at both but not equal (a near tie, also where the order differs);
      the deci-PHRED
      values within 1 of each other, and apart only where the plain value
      lies within 1e-3, or within the tolerance's reach, of a half; af
      within it where the MAP point is the same."""
    problems, worst = {}, {}

    def floats(name, g, r):
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        fin = np.isfinite(r)
        if not (np.array_equal(np.isfinite(g), fin) and np.array_equal(np.isnan(g), np.isnan(r))
                and np.array_equal(g[np.isinf(r)], r[np.isinf(r)])):
            problems[name] = "-inf, +inf or NaN differ"
        err = np.abs(g[fin] - r[fin]) / np.maximum(1.0, np.abs(r[fin]))
        worst[name] = float(err.max(initial=0.0))
        if worst[name] > tol:
            problems[name] = f"error {worst[name]} > {tol}"

    joint_g, marg_g, post_g, combo_g, best_g, wsel_g = got_head
    joint_r, marg_r, post_r, combo_r, best_r, wsel_r = ref_head
    for name, g, r in (("joint", joint_g, joint_r), ("marginal", marg_g, marg_r),
                       ("posteriors", post_g, post_r), ("combo_joint", combo_g, combo_r)):
        floats(name, g, r)
    jr = joint_r.double().cpu().numpy()
    bg, br = best_g.cpu().numpy(), best_r.cpu().numpy()
    same = bg == br
    rows = np.nonzero(~same)[0]
    a, b = jr[rows, bg[rows]], jr[rows, br[rows]]
    # an exact tie goes to the lower index on both sides
    if not np.all((a != b) & (np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b)))):
        problems["best_nonartifact"] = f"{len(rows)} loci differ, not at a near tie"
    worst["best_nonartifact_near_ties"] = len(rows)
    for si, (g, r) in enumerate(zip(wsel_g, wsel_r)):
        if not torch.equal(g[same], r[same]):
            problems[f"wsel[{si}]"] = "differs where the MAP event is the same"

    d_own, U0, comp_of, marginal = tail
    af_g, dph_g, idx_g = (x.cpu().numpy() for x in got_tail)
    af_r, dph_r, idx_r = (x.cpu().numpy() for x in ref_tail)
    m64 = marginal.double().cpu().numpy()
    ov = oi = 0
    for si, own in enumerate(d_own):
        rest = sum((u.double() for c, u in enumerate(U0) if c != comp_of[si]),
                   torch.zeros_like(U0[0], dtype=torch.float64))
        dens = torch.logsumexp(own.double()[:, 0] + rest[:, 0, :, None], dim=1).cpu().numpy()
        K = tables.top_k[si]
        nbb = tables.backbone[si].shape[0]
        ig, ir = idx_g[:, oi:oi + K].astype(np.int64), idx_r[:, oi:oi + K].astype(np.int64)
        vg, vr = np.take_along_axis(dens, ig, 1), np.take_along_axis(dens, ir, 1)
        with np.errstate(invalid="ignore"):
            tie = (vg != vr) & (np.abs(vg - vr) <= tol * np.maximum(1.0, np.abs(vr)))
        if not (tie | (ig == ir)).all():
            problems[f"afd_idx[{si}]"] = "top-K differs, not at a near tie"
        worst[f"afd_idx[{si}]_near_ties"] = int((ig != ir).sum())
        if any(len(set(row)) != K for row in ig):
            problems[f"afd_idx[{si}]"] = "repeats an index"
        # deci-PHRED: the plain value's distance to a half, in float64
        cols = np.concatenate([ir, np.broadcast_to(tables.backbone[si].cpu().numpy(),
                                                   (ir.shape[0], nbb))], axis=1)
        with np.errstate(invalid="ignore"):
            x = -10.0 / math.log(10.0) * (np.take_along_axis(dens, cols, 1) - m64[:, None]) * 10.0
            near = np.abs(np.abs(x - np.floor(x)) - 0.5) <= 1e-3 + 43.5 * tol * (
                np.maximum(1.0, np.abs(np.take_along_axis(dens, cols, 1)))
                + np.maximum(1.0, np.abs(m64[:, None])))
        dg = dph_g[:, ov:ov + K + nbb].astype(np.int64)
        dr = dph_r[:, ov:ov + K + nbb].astype(np.int64)
        diff = np.abs(dg - dr)
        moved = np.concatenate([ig != ir, np.zeros((ir.shape[0], nbb), bool)], axis=1)
        if not ((diff == 0) | ((diff == 1) & (near | moved))).all():
            problems[f"densities_dphred[{si}]"] = f"differs by up to {int(diff.max())}"
        worst[f"densities_dphred[{si}]_off_by_one"] = int((diff == 1).sum())
        top = ig[:, 0] == ir[:, 0]
        e = np.abs(af_g[top, si].astype(np.float64) - af_r[top, si])
        worst[f"af[{si}]"] = float(e.max(initial=0.0))
        if worst[f"af[{si}]"] > tol:
            problems[f"af[{si}]"] = f"error {worst[f'af[{si}]']} > {tol}"
        ov, oi = ov + K + nbb, oi + K
    return problems, worst


def pairhmm_items(n=21, seed=3):
    """Ragged pair-HMM work items (alleles of 40-300 bases, reads of 1-100
    bases cut from them with up to 3 edits, flat qualities 20/30/40): the
    ``_synth`` set of tests/test_pallas_pairhmm.py, drawn from ``random``
    with the same seed.  Returns (alleles, reads, quals)."""
    import random

    random.seed(seed)
    bases = b"ACGT"
    alleles, reads, quals = [], [], []
    for _t in range(n):
        alen = random.choice([40, 100, 192, 300])
        a = bytes(random.choice(bases) for _ in range(alen))
        rlen = random.choice([1, 30, 64, 100])
        p = random.randrange(max(1, alen - rlen)) if alen > rlen else 0
        r = bytearray(a[p : p + min(rlen, alen)])
        for _ in range(random.randrange(4)):
            if not r:
                break
            q = random.randrange(len(r))
            op = random.random()
            if op < 0.4:
                r[q] = random.choice(bases)
            elif op < 0.7:
                r.insert(q, random.choice(bases))
            else:
                del r[q]
        if not r:
            r = bytearray(b"A")
        alleles.append(a)
        reads.append(np.frombuffer(bytes(r), dtype=np.uint8))
        quals.append(np.full(len(r), random.choice([20, 30, 40]), dtype=np.uint8))
    return alleles, reads, quals


def pairhmm_edge_items(seed=0):
    """Edge cases of the pair-HMM kernels, keyed by name, each
    (alleles, reads, quals): an empty read; N and lowercase bases; a read
    longer than its allele; 250-base reads at quality 2-10 (the 1e16
    rescale fires many times); a read bridging a 50-base deletion (the long
    D chain of tests/test_pallas_pairhmm.py:171-185); alleles longer than
    1024 bases (several warps per item on the card)."""
    import random

    rng = np.random.default_rng(seed)
    u8 = lambda b: np.frombuffer(b, dtype=np.uint8)  # noqa: E731

    def rand_seq(n):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes())

    out = {}
    out["empty_read"] = (
        [b"ACGTACGTAC", b"ACGTACGTAC"],
        [np.zeros(0, np.uint8), u8(b"ACGT")],
        [np.zeros(0, np.uint8), np.full(4, 30, np.uint8)],
    )
    a = rand_seq(120)
    out["n_and_lowercase"] = (
        [a, a.lower(), a[:50] + b"N" + a[51:]],
        [u8(a[20:80].lower()), u8(a[20:40] + b"NNN" + a[43:80]), u8(a[30:90])],
        [np.full(60, 30, np.uint8)] * 3,
    )
    a = rand_seq(40)
    out["read_longer_than_allele"] = (
        [a, a[:10]],
        [u8(a + rand_seq(30)), u8(a[:5] + rand_seq(20))],
        [np.full(70, 35, np.uint8), np.full(25, 12, np.uint8)],
    )
    alleles, reads, quals = [], [], []
    for _ in range(8):
        a = rand_seq(300)
        r = bytearray(a[25:275])
        for p in rng.integers(0, 250, 40):
            r[p] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        alleles.append(a)
        reads.append(u8(bytes(r)))
        quals.append(rng.integers(2, 11, 250).astype(np.uint8))
    out["low_quality_250"] = (alleles, reads, quals)
    random.seed(5)
    a = bytes(random.choice(b"ACGT") for _ in range(200))
    out["long_deletion"] = ([a], [u8(a[10:40] + a[90:120])], [np.full(60, 25, np.uint8)])
    alleles, reads, quals = [], [], []
    for alen in (1500, 3000, 1100):
        a = rand_seq(alen)
        p = int(rng.integers(0, alen - 100))
        alleles.append(a)
        reads.append(u8(a[p : p + 100]))
        quals.append(np.full(100, 30, np.uint8))
    out["long_allele"] = (alleles, reads, quals)
    return out


PAIRHMM_TILE_WIDTHS = (32, 64, 96, 128, 160, 256, 1024, 1056)


def semiglobal_distances(alleles, reads):
    """The semiglobal edit distance of each read against its allele (free
    start and end on the allele, the read consumed in full; unit costs), an
    int64 [n] array: the ``hit.dist`` the realigner's band starts from
    (``evidence/realignment.py``: ``max_dists = hit.dist + EDIT_BAND``).
    One numpy DP over the read positions for all items at once."""
    n = len(alleles)
    X = max(len(a) for a in alleles)
    Y = max(len(r) for r in reads)
    al = np.zeros((n, X), np.int16) - 1
    rd = np.zeros((n, Y), np.int16) - 2
    alen = np.array([len(a) for a in alleles])
    rlen = np.array([len(r) for r in reads])
    for b, (a, r) in enumerate(zip(alleles, reads)):
        al[b, : len(a)] = np.frombuffer(bytes(a), np.uint8) & 0xDF
        rd[b, : len(r)] = np.asarray(r, np.uint8) & 0xDF
    big = 1 << 20
    inside = np.arange(X + 1)[None, :] <= alen[:, None]
    row = np.where(inside, 0, big)  # free start on the allele
    best = np.where(rlen == 0, 0, big)
    ramp = np.arange(X + 1)[None, :]
    for j in range(Y):
        diag = row[:, :-1] + (al != rd[:, j : j + 1])
        nxt = np.concatenate([row[:, :1] + 1, np.minimum(diag, row[:, 1:] + 1)], axis=1)
        # the insertions along the allele axis: min over i' <= i of D[i'] + (i - i')
        nxt = np.minimum.accumulate(nxt - ramp, axis=1) + ramp
        row = np.where(inside, nxt, big)
        done = rlen == j + 1
        best = np.where(done, row.min(axis=1), best)
    return best


def pairhmm_tile_items(seed=0):
    """Sets for the tiled layout of K2-K4 (several items per warp), keyed by name,
    each (alleles, reads, quals): reads of 1, 4, 37 and 100 bases side by
    side; allele lengths that are no multiple of the rows per lane; and one
    set per panel width of ``PAIRHMM_TILE_WIDTHS`` (alleles of that length
    and shorter, the last width over 1024 rows)."""
    out = {}
    a, r, q = pairhmm_shape_items(64, 120, 100, seed=seed)
    lens = [1, 4, 37, 100] * 16
    out["mixed_rlen_in_warp"] = (a, [x[:n] for x, n in zip(r, lens)],
                                 [x[:n] for x, n in zip(q, lens)])
    out["alen_not_multiple_of_rows"] = tuple(map(list, zip(*(
        [x[0] for x in pairhmm_shape_items(1, n, min(n, 50), seed=seed + k)]
        for k, n in enumerate([61, 77, 99, 127, 13, 101] * 8)))))
    for X in PAIRHMM_TILE_WIDTHS:
        a, r, q = pairhmm_shape_items(40, X, min(X, 100), seed=seed + X)
        out[f"width_{X}"] = ([x[: X - 7 * (k % 5)] for k, x in enumerate(a)], r, q)
    return out


def pairhmm_shape_items(B, X, Y, seed=0, err=0.01):
    """B work items at one shape: random alleles of X bases, reads of Y bases
    cut from them at a random offset with ``err`` substitutions, PHRED
    qualities N(36, 3) clipped to 10-41 (as the simulated libraries have)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    al = acgt[rng.integers(0, 4, (B, X))]
    off = rng.integers(0, max(1, X - Y + 1), B)
    rd = al[np.arange(B)[:, None], (off[:, None] + np.arange(Y)[None, :]) % X].copy()
    sub = rng.random((B, Y)) < err
    rd[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
    ql = np.clip(rng.normal(36, 3, (B, Y)), 10, 41).astype(np.uint8)
    return [bytes(x) for x in al], list(rd), list(ql)


_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_OP_M, _OP_I, _OP_D, _OP_S = 0, 1, 2, 4
_COMPLEMENT = np.zeros(256, np.uint8)
_COMPLEMENT[_ACGT] = _ACGT[::-1]


def _revcomp(seq):
    return _COMPLEMENT[seq[::-1]]


def _haplotype(ref, events):
    """Apply sorted, non-overlapping events [(pos, kind, length, alt_seq)]
    to ``ref``: "del" deletes ref[pos+1 : pos+1+length]; "ins" inserts
    alt_seq after ref[pos]; "rep" deletes ref[pos+1 : pos+1+length] and
    inserts alt_seq in its place; "snv" / "mnv" put alt_seq over
    ref[pos : pos+len(alt_seq)]; "inv" reverse-complements ref[pos :
    pos+length]; "dup" repeats ref[pos : pos+length] once after itself.
    Returns the haplotype (uint8) and, for each of its bases, its reference
    position: -1 for an inserted base, -(p + 2) for reference base p read
    on the other strand (inside an inversion)."""
    seqs, refpos = [], []
    cur = 0
    for pos, kind, length, alt in events:
        stop = (pos + 1 if kind in ("del", "ins", "rep")
                else pos + length if kind == "dup" else pos)
        seqs.append(ref[cur:stop])
        refpos.append(np.arange(cur, stop, dtype=np.int64))
        if kind == "del":
            cur = pos + 1 + length
        elif kind in ("ins", "rep"):
            seqs.append(np.frombuffer(alt, np.uint8))
            refpos.append(np.full(len(alt), -1, np.int64))
            cur = pos + 1 + (length if kind == "rep" else 0)
        elif kind == "inv":
            seqs.append(_revcomp(ref[pos : pos + length]))
            refpos.append(-np.arange(pos + length - 1, pos - 1, -1, dtype=np.int64) - 2)
            cur = pos + length
        elif kind == "dup":
            seqs.append(ref[pos : pos + length])
            refpos.append(np.arange(pos, pos + length, dtype=np.int64))
            cur = pos + length
        else:
            seqs.append(np.frombuffer(alt, np.uint8))
            refpos.append(np.arange(pos, pos + len(alt), dtype=np.int64))
            cur = pos + len(alt)
    seqs.append(ref[cur:])
    refpos.append(np.arange(cur, len(ref), dtype=np.int64))
    return np.concatenate(seqs), np.concatenate(refpos)


def _off_the_line(rp):
    """Whether a read's bases leave the reference's forward line other than
    by an indel: bases on the other strand, or positions that step back."""
    return bool((rp <= -2).any() or (np.diff(rp[rp >= 0]) <= 0).any())


def _split_alignment(seq, rp):
    """What an aligner reports for a read across an SV junction (``rp`` as
    :func:`_haplotype` gives it): a read with most of its bases on the other
    strand aligns reversed (the reverse complement, positions mirrored);
    then the longest stretch of bases in reference order stays aligned and
    the rest is soft-clipped.  Returns (seq, positions with the clipped
    bases at -1, reversed)."""
    flipped = 2 * int((rp <= -2).sum()) > len(rp)
    if flipped:
        seq = _revcomp(seq)
        rp = np.where(rp == -1, -1, -rp - 2)[::-1]
    best, start, last = (0, 0), 0, -1
    for i, p in enumerate(rp.tolist() + [-2]):
        if p <= -2 or 0 <= p <= last:
            if i - start > best[1] - best[0]:
                best = (start, i)
            start, last = (i + 1, -1) if p <= -2 else (i, p)
        elif p >= 0:
            last = p
    out = np.full(len(rp), -1, np.int64)
    out[best[0] : best[1]] = rp[best[0] : best[1]]
    return seq, out, flipped


def _clip_reads(rng, rows, seqs, cigars, ref_start, ref_end, L, lo, hi, lead):
    """Soft-clip ``rows`` (reads with one M op): lo-hi random bases at the
    read's start (``lead``) or end, as adapter remnants and chimeric ends
    leave them."""
    for i in rows.tolist():
        k = int(rng.integers(lo, hi + 1))
        junk = _ACGT[rng.integers(0, 4, k)]
        if lead:
            seqs[i, :k] = junk
            cigars[i] = [(_OP_S, k), (_OP_M, L - k)]
            ref_start[i] += k
        else:
            seqs[i, L - k :] = junk
            cigars[i] = [(_OP_M, L - k), (_OP_S, k)]
            ref_end[i] = ref_start[i] + L - k


def _read_refpos(cigar, start, L):
    """Reference position of each read base (-1: inserted or clipped)."""
    if cigar is None:
        return start + np.arange(L)
    out, q, p = np.full(L, -1, np.int64), 0, start
    for op, n in cigar:
        if op == _OP_M:
            out[q : q + n] = np.arange(p, p + n)
            q, p = q + n, p + n
        elif op in (_OP_I, _OP_S):
            q += n
        elif op == _OP_D:
            p += n
    return out


def _methylation_tags(seq, rp, meth, rng):
    """5mC MM / ML tags (SAM tags spec) of a forward-strand read: a call at
    every C that sits on a CpG of the reference (``meth``: -1 no CpG, 0
    unmethylated, 1 methylated), ML drawn high with probability 0.9 on a
    methylated CpG and 0.05 on an unmethylated one."""
    cs = np.nonzero(seq == ord("C"))[0]
    on = rp[cs]
    keep = on >= 0
    keep[keep] = meth[on[keep]] >= 0
    idx = np.nonzero(keep)[0]
    if not len(idx):
        return {}
    high = rng.random(len(idx)) < np.where(meth[on[idx]] == 1, 0.9, 0.05)
    ml = np.where(high, rng.integers(180, 256, len(idx)), rng.integers(0, 61, len(idx)))
    deltas = np.diff(np.concatenate([[-1], idx])) - 1
    return {"MM": "C+m," + ",".join(map(str, deltas.tolist())) + ";",
            "ML": ml.astype(np.uint8)}


def _cigar(rp):
    """CIGAR of a read whose bases sit at reference positions ``rp`` (-1:
    inserted), as an aligner writes it: M runs, I for inserted bases, D for
    skipped reference bases, S for inserted bases at either end."""
    aligned = np.nonzero(rp >= 0)[0]
    first, last = int(aligned[0]), int(aligned[-1])
    ops = [[_OP_S, first]] if first else []

    def add(op, n):
        if ops and ops[-1][0] == op:
            ops[-1][1] += n
        else:
            ops.append([op, n])

    prev = -1
    for p in rp[first : last + 1].tolist():
        if p < 0:
            add(_OP_I, 1)
            continue
        if prev >= 0 and p != prev + 1:
            add(_OP_D, p - prev - 1)
        add(_OP_M, 1)
        prev = p
    if last < len(rp) - 1:
        ops.append([_OP_S, len(rp) - 1 - last])
    return [(op, n) for op, n in ops]


_HP_MIN, _HP_MAX = 5, 12  # planted homopolymer runs: lengths
_HP_SPACING = 150  # about one planted run per this many bases
_SLIP_RATE = 0.005  # per base of a run a read crosses: a +-1 length slip


def _homopolymer_runs(seq, min_len=_HP_MIN):
    """(starts, lengths) of the runs of one base of at least ``min_len``."""
    brk = np.nonzero(seq[1:] != seq[:-1])[0] + 1
    starts = np.concatenate([[0], brk])
    lens = np.diff(np.concatenate([starts, [len(seq)]]))
    keep = lens >= min_len
    return starts[keep], lens[keep]


def _write_runs(ref, starts, lens, rng):
    """Write a run of one random base at each start (``lens`` bases), the
    base unlike the bases just before and after the run; returns the bases."""
    idx = np.zeros(256, np.int64)
    idx[_ACGT] = np.arange(4)
    left, right = idx[ref[starts - 1]], idx[ref[starts + lens]]
    b = (left + 1 + rng.integers(0, 3, len(starts))) % 4  # != left
    b = np.where(b == right, (b + 1) % 4, b)
    b = np.where(b == left, (b + 1) % 4, b)  # then b + 2 != right either
    off = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
    ref[np.repeat(starts, lens) + off] = np.repeat(_ACGT[b], lens)
    return _ACGT[b]


def _plant_homopolymers(ref, pos, role, rng):
    """The homopolymer profile's reference: half of the germline, somatic and
    decoy indel sites (roles 0-2) get a run of 5-12 bases just after their
    anchor base, where the indel becomes a run-length change of 1-3 bases;
    other runs of 5-12 bases are written about every 150 bases, at least 30
    bases from any variant.  Edits ``ref`` in place; returns the in-run mask
    over the variants and their length changes."""
    n = len(pos)
    in_run = np.zeros(n, dtype=bool)
    for r in range(3):
        sites = np.nonzero(role == r)[0]
        in_run[rng.choice(sites, len(sites) // 2, replace=False)] = True
    change = rng.integers(1, 4, n)
    at = pos[in_run] + 1
    _write_runs(ref, at, rng.integers(_HP_MIN, _HP_MAX + 1, len(at)), rng)
    bg = np.arange(_HP_SPACING, len(ref) - _HP_SPACING, _HP_SPACING)
    bg = bg + rng.integers(0, _HP_SPACING - _HP_MAX - 8, len(bg))
    k = np.searchsorted(pos, bg)
    prev = np.where(k > 0, bg - pos[np.maximum(k - 1, 0)], 1 << 30)
    nxt = np.where(k < n, pos[np.minimum(k, n - 1)] - bg, 1 << 30)
    bg = bg[(prev >= 30) & (nxt >= 30)]
    _write_runs(ref, bg, rng.integers(_HP_MIN, _HP_MAX + 1, len(bg)), rng)
    return in_run, change


def _slip_reads(rows, starts, hseq, hmap, L, rng, seqs, cigars, ref_start, ref_end):
    """PCR slips: every run of >= 5 bases that a read crosses whole (a base
    of the read on each side) gains or loses one base, each equally likely,
    with probability 0.005 x the run's length.  The read keeps L bases; the
    I or D sits at the run's first base, where an aligner left-aligns it."""
    rs, rl = _homopolymer_runs(hseq)
    first = np.searchsorted(rs, starts + 1)
    last = np.searchsorted(rs + rl, starts + L - 1, side="right")
    n = np.maximum(last - first, 0)
    read = np.repeat(np.arange(len(rows)), n)
    run = np.repeat(first, n) + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    hit = rng.random(len(run)) < _SLIP_RATE * rl[run]
    ins = rng.random(len(run)) < 0.5
    read, run, ins = read[hit], run[hit], ins[hit]
    bounds = np.nonzero(np.diff(read))[0] + 1
    for k, rk, ik in zip(np.split(read, bounds), np.split(run, bounds), np.split(ins, bounds)):
        if not len(k):
            continue
        s0 = int(starts[k[0]])
        span = L + int((~ik).sum())
        if s0 + span > len(hseq):
            continue
        sq, rp = hseq[s0 : s0 + span].copy(), hmap[s0 : s0 + span].copy()
        for r, is_ins in zip(rk[::-1].tolist(), ik[::-1].tolist()):  # right to left
            off = int(rs[r]) - s0
            if is_ins:
                sq, rp = np.insert(sq, off, sq[off]), np.insert(rp, off, -1)
            else:
                sq, rp = np.delete(sq, off), np.delete(rp, off)
        i = rows[k[0]]
        seqs[i], rp = sq[:L], rp[:L]
        cigars[i] = _cigar(rp)
        ref_start[i], ref_end[i] = rp[rp >= 0][0], rp.max() + 1


def _simulate_library(path, chrom, ref_len, haps, rng, coverage, read_len,
                      insert_mean, insert_sd, base_error, slip_rng=None, clips=(),
                      meth=None, meth_rng=None):
    """Paired-end library over a diploid genome (each fragment samples one
    haplotype), sorted and written with BamWriter + BAI.  With ``slip_rng``,
    reads carry homopolymer slips (:func:`_slip_reads`) drawn from it.  A
    read across an SV junction is aligned by :func:`_split_alignment`.
    ``clips``: (rng, n, lo, hi, lead, from_pos) each soft-clips n reads with
    one M op that start at or after from_pos (:func:`_clip_reads`); ``meth``
    (per reference base: -1 no CpG, 0 / 1 un- / methylated) puts 5mC MM / ML
    tags drawn from ``meth_rng`` on the forward-strand reads."""
    from .io.bam import BamRecord, BamWriter

    L = read_len
    n_pairs = int(ref_len * coverage / (2 * L))
    hsel = rng.integers(0, 2, n_pairs)
    isize = np.clip(rng.normal(insert_mean, insert_sd, n_pairs), 2 * L + 10,
                    insert_mean + 5 * insert_sd).astype(np.int64)
    hap_len = np.array([len(h[0]) for h in haps])
    fstart = (rng.random(n_pairs) * (hap_len[hsel] - isize)).astype(np.int64)
    # flat read table: read 2k is the pair's forward first read, 2k+1 its mate
    start = np.empty(2 * n_pairs, np.int64)
    start[0::2] = fstart
    start[1::2] = fstart + isize - L
    hap_of = np.repeat(hsel, 2)
    N = 2 * n_pairs
    seqs = np.empty((N, L), np.uint8)
    ref_start = np.empty(N, np.int64)
    ref_end = np.empty(N, np.int64)
    cigars = [None] * N  # None: one M op of L bases
    flipped = np.zeros(N, dtype=bool)
    for h, (hseq, hmap) in enumerate(haps):
        sel = np.nonzero(hap_of == h)[0]
        s = start[sel]
        seqs[sel] = hseq[s[:, None] + np.arange(L)[None, :]]
        ins_cum = np.concatenate([[0], np.cumsum(hmap < 0)])
        plain = (ins_cum[s + L] == ins_cum[s]) & (hmap[s + L - 1] - hmap[s] == L - 1)
        ref_start[sel] = hmap[s]
        ref_end[sel] = hmap[s + L - 1] + 1
        # reads off the reference's straight line carry an indel (or a clip)
        for i, si in zip(sel[~plain].tolist(), s[~plain].tolist()):
            rp = hmap[si : si + L]
            if _off_the_line(rp):
                seqs[i], rp, flipped[i] = _split_alignment(seqs[i], rp)
            cigars[i] = _cigar(rp)
            ref_start[i] = rp[rp >= 0][0]
            ref_end[i] = rp.max() + 1
        if slip_rng is not None:
            _slip_reads(sel, s, hseq, hmap, L, slip_rng, seqs, cigars, ref_start, ref_end)
    n_err = rng.binomial(L, base_error, N)
    rows = np.repeat(np.arange(N), n_err)
    seqs[rows, rng.integers(0, L, len(rows))] = _ACGT[rng.integers(0, 4, len(rows))]
    for crng, n, lo, hi, lead, from_pos in clips:
        one_m = np.array([c is None for c in cigars]) & (ref_start >= from_pos)
        rows = crng.choice(np.nonzero(one_m)[0], n, replace=False)
        _clip_reads(crng, rows, seqs, cigars, ref_start, ref_end, L, lo, hi, lead)
    qual_pool = np.clip(rng.normal(36, 3, size=(256, L)), 10, 41).astype(np.uint8)
    tlen = (np.maximum(ref_end[0::2], ref_end[1::2])
            - np.minimum(ref_start[0::2], ref_start[1::2]))
    order = np.argsort(ref_start, kind="stable")
    w = BamWriter(path, [chrom], [ref_len])
    for i in order.tolist():
        k, first = i >> 1, (i & 1) == 0
        mate = i + 1 if first else i - 1
        flag = (0x1 | 0x2 | (0x10 if first == flipped[i] else 0)
                | (0x20 if first != flipped[mate] else 0) | (0x40 if first else 0x80))
        tags = {}
        if meth is not None and not flipped[i]:
            tags = _methylation_tags(seqs[i], _read_refpos(cigars[i], int(ref_start[i]), L),
                                     meth, meth_rng)
        w.write_record(
            BamRecord(
                qname=f"frag{k}", flag=flag, tid=0, pos=int(ref_start[i]), mapq=60,
                cigar=cigars[i] or [(_OP_M, L)], mtid=0, mpos=int(ref_start[mate]),
                tlen=int(tlen[k]) if first else -int(tlen[k]),
                seq=seqs[i], qual=qual_pool[k % 256], tags=tags,
            )
        )
    w.close(index=True)
    return N


# the all-kinds world of the CPU and card tests: TINY_WORLD's coverage and
# reads (tests/test_torch_preprocess.py) on a 40 kb contig, which the SV
# zones need, with every option on
KINDS_WORLD = dict(seed=1, genome_len=40_000, coverage=6.0, n_germline=8, n_somatic=6,
                   n_decoy=6, n_snv=4, kinds=4, ratchet=4, methylation=4, sv_len=(150, 400))
# the candidate kinds the option adds, as VariantInfo.kind names them
OTHER_KINDS = ("mnv", "none", "inversion", "duplication", "replacement", "breakend",
               "methylation")

_SV_MARGIN = 250  # bases kept free of other variants around an SV zone


def _sv_zones(rng, genome_len, lens):
    """Place zones of ``lens`` bases (each with _SV_MARGIN on both sides)
    apart from each other at random in [500, genome_len - 500); returns
    their starts, in the order of ``lens``."""
    span = np.asarray(lens) + 2 * _SV_MARGIN
    free = genome_len - 1000 - int(span.sum())
    if free <= 0:
        raise ValueError(f"{len(lens)} SVs do not fit in {genome_len} bases")
    order = rng.permutation(len(lens))
    gaps = np.floor(rng.dirichlet(np.ones(len(lens) + 1)) * free).astype(np.int64)
    starts = np.empty(len(lens), np.int64)
    at = 500
    for k, z in enumerate(order.tolist()):
        at += int(gaps[k])
        starts[z] = at + _SV_MARGIN
        at += int(span[z])
    return starts


def _inversion_breakends(ref, chrom, s, e, name):
    """The four BND records of the inversion of ref[s:e] (VCF 4.2 joins,
    the breakends varlociraptor builds for an INV record): (pos, REF, ALT,
    ID, INFO)."""
    b = lambda p: chr(ref[p])  # noqa: E731
    ids = {k: f"{name}_{k}" for k in "wvux"}
    rows = [(s - 1, f"{b(s - 1)}]{chrom}:{e}]", "w", "u"),
            (s, f"[{chrom}:{e + 1}[{b(s)}", "v", "x"),
            (e - 1, f"{b(e - 1)}]{chrom}:{s}]", "u", "w"),
            (e, f"[{chrom}:{s + 1}[{b(e)}", "x", "v")]
    return [(p, b(p), alt, ids[i], f"SVTYPE=BND;MATEID={ids[m]};EVENT={name}")
            for p, alt, i, m in rows]


def _plan_kinds(krng, ref, chrom, genome_len, kinds, sv_len):
    """The SV zones of the all-kinds world: ``kinds`` INV and ``kinds`` DUP
    records (half of each planted, the rest decoys at zones with no SV) and
    the inversions written as BND groups (``kinds`` records: four per
    group, half planted).  Returns (events by role, candidate rows, zone
    [lo, hi) array, truth)."""
    n_half = kinds // 2
    n_bnd = max(kinds // 4, 1)
    kind_of = (["inversion"] * kinds + ["duplication"] * kinds + ["breakend"] * n_bnd)
    lo, hi = sv_len
    lens = np.exp(krng.uniform(np.log(lo), np.log(hi), len(kind_of))).astype(np.int64)
    starts = _sv_zones(krng, genome_len, lens)
    events = {"germline": [], "somatic": []}
    rows, truth = [], {}
    seen = {}
    for kind, s, L in zip(kind_of, starts.tolist(), lens.tolist()):
        i = seen[kind] = seen.get(kind, -1) + 1
        planted = i < (n_half if kind != "breakend" else (n_bnd + 1) // 2)
        role = ("germline" if i % 2 == 0 else "somatic") if planted else "decoy"
        truth.setdefault(kind, {"germline": [], "somatic": [], "decoy": []})
        if kind == "breakend":
            grp = _inversion_breakends(ref, chrom, s, s + L, f"bnd{i}")
            rows += grp
            truth[kind][role] += [r[0] for r in grp]
        else:
            sym = "<INV>" if kind == "inversion" else "<DUP>"
            rows.append((s, chr(ref[s]), sym, ".",
                         f"SVTYPE={sym[1:4]};END={s + L}"))
            truth[kind][role].append(s)
        if planted:
            events[role].append((s, "inv" if kind != "duplication" else "dup", L, None))
    zones = np.stack([starts - _SV_MARGIN, starts + lens + _SV_MARGIN], axis=1)
    return events, rows, zones, truth


def _random_bases_unlike(rng, ref_bases):
    """One random base unlike each of ``ref_bases``."""
    idx = np.zeros(256, np.int64)
    idx[_ACGT] = np.arange(4)
    return _ACGT[(idx[ref_bases] + rng.integers(1, 4, len(ref_bases))) % 4]


def synth_preprocess_world(out_dir, seed=0, genome_len=2_000_000, coverage=30.0,
                           read_len=100, insert_mean=350.0, insert_sd=50.0,
                           base_error=0.003, n_germline=1000, n_somatic=500,
                           n_decoy=500, n_snv=0, chrom="chr1", homopolymer=False,
                           kinds=0, ratchet=0, methylation=0, sv_len=(150, 2000)):
    """A tumor/normal preprocess world: FASTA, two indexed BAMs, candidates.

    One random contig of ``genome_len`` bases.  ``n_germline`` heterozygous
    indels (and ``n_snv`` heterozygous SNVs) sit on haplotype 1 of both
    samples, ``n_somatic`` indels on haplotype 1 of the tumor only.  Indels
    are half deletions and half insertions, half of them 1 bp long and the
    rest 2-10 bp.  Each sample is a paired-end library (``read_len`` x 2 at
    ``coverage``, insert size N(insert_mean, insert_sd), substitution errors
    at ``base_error``, PHRED qualities N(36, 3) clipped to 10-41, as
    scripts/bench_e2e_large.py simulates them); a read that crosses a
    planted indel carries its D or I op in the CIGAR.  The candidates VCF
    (position-sorted) lists every planted variant and ``n_decoy`` indels at
    sites that carry none.

    ``homopolymer=True`` (off by default; with it off, the draws and the
    files are those of the plain world): the error profile of a
    PCR-amplified library.  Homopolymer runs of 5-12 bases of one random
    base are written into the reference, about one per 150 bases; half of
    the germline, somatic and decoy indels sit at the start of a run, as a
    run-length change of 1-3 bases; and every run of >= 5 bases that a read
    crosses whole slips by one base (an I or D in the CIGAR) with
    probability 0.005 x its length.  These draws come from a second
    generator seeded with (seed, 1).

    The options below are off (0) by default, and then the draws and the
    files are those of the plain world; their draws come from a generator
    seeded with (seed, 2).

    ``kinds=n``: candidates of every other kind that
    ``calling/variants.py`` classifies, each kind half planted (alternately
    germline on haplotype 1 of both samples and somatic on the tumor's) and
    half decoys at sites that carry none: n MNVs (2-3 bases), n
    replacements (REF and ALT of 2-8 bases, of unequal length), n ``<*>``
    (``none``) records, n inversions and n tandem duplications of
    ``sv_len`` bases (log-uniform; ``<INV>`` / ``<DUP>`` with END), and
    max(n // 4, 1) inversions written as groups of four BND records
    (SVTYPE=BND, MATEID, EVENT).  A read across an SV junction carries a
    soft clip (:func:`_split_alignment`); one inside an inversion aligns to
    the other strand.

    ``ratchet=n``: what moves the alignment-property maxima during a tumor
    preprocess (``max_del_cigar_len``, ``max_ins_cigar_len``,
    ``frac_max_softclip``) beyond what ``estimate`` finds on the normal: n
    somatic indels of 20-60 bases in the second half of the contig, n decoy
    indels of 15-60 bases anywhere, 4n tumor reads in the second half with
    a soft clip of 55-75 bases, and 4n normal reads with a clip of 5-15
    bases (so that the normal's estimate has a soft-clip fraction at all).

    ``methylation=n``: 5mC MM / ML tags on every forward-strand read at each
    C of a reference CpG (half of the CpGs methylated), and n ``<METH>``
    candidates at CpGs that ``candidates/methylation.py`` finds, half of
    them methylated, half not.

    Returns {"fasta", "tumor", "normal", "candidates", "n_candidates",
    "reads": {sample: n}, "truth": {"germline", "somatic", "decoy", "snv":
    0-based VCF positions}}; the homopolymer world's truth also holds
    "in_run", the positions of the indels inside runs, and the options'
    "kinds": {kind: {"germline", "somatic", "decoy"}: positions} (for
    methylation: "methylated" and "decoy"; the ratchet's indels under
    "ratchet")."""
    from pathlib import Path

    rng = np.random.default_rng(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ref = _ACGT[rng.integers(0, 4, genome_len)]
    n_indel = n_germline + n_somatic + n_decoy
    n_total = n_indel + n_snv
    gap = max(30, min(300, (genome_len - 1000) // (2 * max(n_total, 1))))
    slots = np.arange(500, genome_len - 500, gap)
    extra = bool(kinds or ratchet or methylation)
    krng = np.random.default_rng([seed, 2]) if extra else None
    sv_events, sv_rows, zones, kind_truth = {"germline": [], "somatic": []}, [], None, {}
    if kinds:
        sv_events, sv_rows, zones, kind_truth = _plan_kinds(
            krng, ref, chrom, genome_len, kinds, sv_len)
        inside = ((slots[:, None] >= zones[:, 0]) & (slots[:, None] < zones[:, 1])).any(1)
        slots = slots[~inside]
    if len(slots) < n_total:
        raise ValueError(f"{n_total} variants do not fit in {genome_len} bases")
    if ratchet and gap < 80:
        raise ValueError("the ratchet's 60-base indels need slots 80 bases apart")
    pos = np.sort(rng.choice(slots, n_total, replace=False))
    role = rng.permutation(
        np.repeat(np.arange(4), [n_germline, n_somatic, n_decoy, n_snv])
    )
    is_del = rng.permutation(np.arange(n_total) % 2 == 0)
    length = np.where(rng.permutation(np.arange(n_total)) < n_total // 2, 1,
                      rng.integers(2, 11, n_total))
    in_run, hrng = np.zeros(n_total, dtype=bool), None
    if homopolymer:
        hrng = np.random.default_rng([seed, 1])
        in_run, change = _plant_homopolymers(ref, pos, role, hrng)
        length = np.where(in_run, change, length)
    events, rows = {0: [], 1: [], 2: [], 3: []}, []
    for p, r, d, ln, hp in zip(pos.tolist(), role.tolist(), is_del.tolist(),
                               length.tolist(), in_run.tolist()):
        if r == 3:
            alt = bytes([int(rng.choice(_ACGT[_ACGT != ref[p]]))])
            ev = (p, "snv", 1, alt)
            rows.append((p, ref[p : p + 1].tobytes(), alt))
        elif d:
            ev = (p, "del", ln, b"")
            rows.append((p, ref[p : p + 1 + ln].tobytes(), ref[p : p + 1].tobytes()))
        else:
            ins = _ACGT[rng.integers(0, 4, ln)].tobytes()
            if hp:  # the run's own base: a longer run
                ins = ref[p + 1 : p + 2].tobytes() * ln
            ev = (p, "ins", ln, ins)
            rows.append((p, ref[p : p + 1].tobytes(), ref[p : p + 1].tobytes() + ins))
        events[r].append(ev)
    rows = [(p, rb.decode(), ab.decode(), ".", ".") for p, rb, ab in rows]
    fasta = out / "ref.fa"
    with open(fasta, "w") as f:
        f.write(f">{chrom}\n")
        text = ref.tobytes().decode("ascii")
        f.writelines(text[i : i + 80] + "\n" for i in range(0, genome_len, 80))
    clips, meth, mrng = {"normal": [], "tumor": []}, None, None
    if extra:
        free = np.setdiff1d(slots, pos)
        events[0] += sv_events["germline"]
        events[1] += sv_events["somatic"]
        rows += sv_rows
        small = _plan_small_kinds(krng, ref, free, genome_len, kinds, ratchet)
        for r, evs in small["events"].items():
            events[r] += evs
        rows += small["rows"]
        kind_truth.update(small["truth"])
        if ratchet:
            clips["tumor"].append((krng, 4 * ratchet, 55, 75, False, genome_len // 2))
            clips["normal"].append((krng, 4 * ratchet, 5, 15, True, 0))
        if methylation:
            mrng = np.random.default_rng([seed, 3])
            meth, meth_rows, kind_truth["methylation"] = _plan_methylation(
                krng, fasta, len(ref), methylation, zones,
                np.array(sorted(r[0] for r in rows)))
            rows += meth_rows
        rows.sort(key=lambda r: r[0])
    germ = sorted(events[0] + events[3])
    haps = {
        "normal": (_haplotype(ref, []), _haplotype(ref, germ)),
        "tumor": (_haplotype(ref, []), _haplotype(ref, sorted(germ + events[1]))),
    }
    reads = {}
    for sample in ("normal", "tumor"):
        reads[sample] = _simulate_library(
            out / f"{sample}.bam", chrom, genome_len, haps[sample], rng,
            coverage, read_len, insert_mean, insert_sd, base_error, slip_rng=hrng,
            clips=clips[sample], meth=meth, meth_rng=mrng,
        )
    cand = out / "candidates.vcf"
    with open(cand, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                f"##contig=<ID={chrom},length={genome_len}>\n")
        if kinds:
            f.writelines(f'##INFO=<ID={k},Number={n},Type={ty},Description="{k}">\n'
                         for k, n, ty in (("SVTYPE", 1, "String"), ("END", 1, "Integer"),
                                          ("MATEID", ".", "String"), ("EVENT", 1, "String")))
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for p, rb, ab, rid, info in rows:  # rows follow pos
            f.write(f"{chrom}\t{p + 1}\t{rid}\t{rb}\t{ab}\t.\t.\t{info}\n")
    names = ("germline", "somatic", "decoy", "snv")
    truth = {names[r]: pos[role == r] for r in range(4)}
    if homopolymer:
        truth["in_run"] = pos[in_run]
    if extra:
        truth["kinds"] = kind_truth
    return {"fasta": str(fasta), "tumor": str(out / "tumor.bam"),
            "normal": str(out / "normal.bam"), "candidates": str(cand),
            "n_candidates": len(rows), "reads": reads, "truth": truth}


def _plan_small_kinds(krng, ref, free, genome_len, kinds, ratchet):
    """MNVs, replacements and ``<*>`` records (``kinds`` each), and the
    ratchet's long indels (``ratchet`` somatic ones in the second half of
    the contig, ``ratchet`` decoys anywhere), at the free slots.  Returns
    {"events": {role: [...]}, "rows": [...], "truth": {...}}."""
    events, rows, truth = {0: [], 1: []}, [], {}
    n_long = 2 * ratchet
    if len(free) < 3 * kinds + n_long:
        raise ValueError("the other kinds do not fit between the indels")
    late = free[free >= genome_len // 2]
    if len(late) < ratchet:
        raise ValueError("the ratchet's indels do not fit in the second half")
    long_som = np.sort(krng.choice(late, ratchet, replace=False))
    rest = np.setdiff1d(free, long_som)
    at = krng.permutation(rest)[: 3 * kinds + ratchet]
    n_half = kinds // 2
    for k, kind in enumerate(("mnv", "replacement", "none")):
        sites = at[k * kinds : (k + 1) * kinds].tolist()
        truth[kind] = {"germline": [], "somatic": [], "decoy": []}
        for i, p in enumerate(sites):
            planted = kind != "none" and i < n_half
            role = ("germline" if i % 2 == 0 else "somatic") if planted else "decoy"
            truth[kind][role].append(p)
            if kind == "none":
                rows.append((p, chr(ref[p]), "<*>", ".", "."))
                continue
            if kind == "mnv":
                m = int(krng.integers(2, 4))
                alt = _random_bases_unlike(krng, ref[p : p + m]).tobytes()
                ev = (p, "mnv", m, alt)
                rb, ab = ref[p : p + m].tobytes(), alt
            else:
                dl, il = krng.choice(np.arange(1, 8), 2, replace=False).tolist()
                tail = _ACGT[krng.integers(0, 4, il)].tobytes()
                ev = (p, "rep", dl, tail)
                rb, ab = ref[p : p + 1 + dl].tobytes(), ref[p : p + 1].tobytes() + tail
            rows.append((p, rb.decode(), ab.decode(), ".", "."))
            if planted:
                events[0 if role == "germline" else 1].append(ev)
    truth["ratchet"] = {"somatic": long_som.tolist(), "decoy": []}
    long_decoy = at[3 * kinds :]
    for p, r in [(p, 1) for p in long_som.tolist()] + [(p, 2) for p in long_decoy.tolist()]:
        ln = int(krng.integers(20 if r == 1 else 15, 61))
        if krng.random() < 0.5:
            ev = (p, "del", ln, b"")
            rb, ab = ref[p : p + 1 + ln].tobytes(), ref[p : p + 1].tobytes()
        else:
            ins = _ACGT[krng.integers(0, 4, ln)].tobytes()
            ev = (p, "ins", ln, ins)
            rb, ab = ref[p : p + 1].tobytes(), ref[p : p + 1].tobytes() + ins
        rows.append((p, rb.decode(), ab.decode(), ".", "."))
        if r == 1:
            events[1].append(ev)
        else:
            truth["ratchet"]["decoy"].append(p)
    return {"events": events, "rows": rows, "truth": truth}


def _plan_methylation(krng, fasta, ref_len, n, zones, taken):
    """The methylation state of every CpG (half methylated) and ``n``
    ``<METH>`` candidates at CpGs that ``candidates.methylation`` finds in
    the world's reference, outside the SV zones and at least 10 bases from
    any other candidate; half of them methylated.  Returns (state per
    reference base: -1 no CpG, 0, 1; rows; truth)."""
    from .candidates.methylation import find_candidates
    from .io.vcf import open_variant_file

    cpg_vcf = fasta.parent / "cpg.vcf"
    find_candidates(str(fasta), str(cpg_vcf))
    cpg = np.array([r.pos for r in open_variant_file(str(cpg_vcf))], np.int64)
    meth = np.full(ref_len, -1, np.int8)
    meth[cpg] = krng.random(len(cpg)) < 0.5
    ok = np.ones(len(cpg), dtype=bool)
    if zones is not None:
        ok &= ~((cpg[:, None] >= zones[:, 0]) & (cpg[:, None] < zones[:, 1])).any(1)
    k = np.searchsorted(taken, cpg)
    near = np.minimum(np.abs(cpg - taken[np.clip(k - 1, 0, len(taken) - 1)]),
                      np.abs(taken[np.clip(k, 0, len(taken) - 1)] - cpg))
    ok &= near >= 10
    if ok.sum() < n:
        raise ValueError(f"{n} methylation candidates do not fit")
    sites = np.sort(krng.choice(cpg[ok], n, replace=False))
    state = np.zeros(n, np.int8)
    state[: n // 2] = 1
    state = krng.permutation(state)
    meth[sites] = state
    rows = [(p, "C", "<METH>", ".", ".") for p in sites.tolist()]
    truth = {"methylated": sites[state == 1].tolist(), "decoy": sites[state == 0].tolist()}
    return meth, rows, truth


def _write_synth_sample(path, name, variants, vaf, rng, min_depth, max_depth):
    """One sample's observation file for ``variants``: depths drawn from
    [min_depth, max_depth], each read alt with probability ``vaf`` of its
    locus (synth_batch's feature distributions).  Returns the path."""
    from .calling.observations import ObservationWriter, ObsColumns
    from .evidence.observation import HOMOPOLYMER_NONE
    from .ops.compact_obs import (
        CF_PDO, CF_PHA, CF_PHB, CF_PHV, CF_PM, CF_PME, CF_PR, CF_PSA, CF_PA,
        CU_FLAGS, CU_RO, CU_STRAND, FLAG_IS_MAX_MAPQ, FLAG_PAIRED, N_CF, N_CU,
    )

    n_loci = len(variants)
    strong = math.log(1 - 1e-4)
    weak = math.log(1e-4)
    counts = rng.integers(min_depth, max_depth + 1, n_loci)
    N = int(counts.sum())
    is_alt = rng.random(N) < np.repeat(vaf, counts)
    f16 = np.zeros((N, N_CF), np.float16)
    f16[:, CF_PM] = math.log(1 - 1e-5)
    f16[:, CF_PA] = np.where(is_alt, strong, weak)
    f16[:, CF_PR] = np.where(is_alt, weak, strong)
    f16[:, CF_PME] = math.log(0.5)
    f16[:, CF_PSA] = 0.0
    f16[:, CF_PDO] = -np.inf
    f16[:, CF_PHB] = math.log(1.0 / 100)
    f16[:, CF_PHA] = np.nan
    f16[:, CF_PHV] = np.nan
    u8 = np.zeros((N, N_CU), np.uint8)
    u8[:, CU_STRAND] = rng.integers(1, 3, N)
    u8[:, CU_RO] = rng.integers(1, 3, N)
    u8[:, CU_FLAGS] = FLAG_PAIRED | np.where(
        rng.random(N) < 0.9, FLAG_IS_MAX_MAPQ, 0
    )
    cols = ObsColumns(
        f16, u8, np.full(N, HOMOPOLYMER_NONE, np.int8),
        np.full(N, -1, np.int16), np.full(N, -1, np.int64),
    )
    off = np.concatenate([[0], np.cumsum(counts)])
    with ObservationWriter(str(path), name) as w:
        for s in range(0, n_loci, 1024):
            e = min(n_loci, s + 1024)
            w.write_window(
                variants[s:e], counts[s:e],
                cols.slice(int(off[s]), int(off[e])), counts[s:e],
            )
    return str(path)


def synth_observation_files(out_dir, n_loci=1000, seed=0, purity=0.75,
                            frac_somatic=0.05, frac_germline=0.05,
                            min_depth=20, max_depth=64, chrom="chr1"):
    """Tumor and normal observation files (binary ``vlt-tpu-2``) for
    ``n_loci`` SNV candidates, written with ``ObservationWriter.write_window``.

    Reads follow :func:`synth_batch`'s feature distributions (strong/weak
    alt/ref log-probs, mapping 1-1e-5, missed allele 0.5, hit base 0.01,
    random strand and orientation) at depths drawn from
    [min_depth, max_depth].  A ``frac_somatic`` share of loci carries a
    tumor-only alt allele (tumor VAF = purity * U(0.2, 1)), a
    ``frac_germline`` share a germline allele (VAF 0.5 or 1.0 in both
    samples); the rest are reference.

    Returns (tumor_path, normal_path, truth) where truth maps "somatic" and
    "germline" to 0-based candidate positions."""
    from pathlib import Path

    from .calling.variants import VariantInfo

    rng = np.random.default_rng(seed)
    u = rng.random(n_loci)
    somatic = u < frac_somatic
    germline = (u >= frac_somatic) & (u < frac_somatic + frac_germline)
    germ_af = np.where(rng.random(n_loci) < 0.8, 0.5, 1.0)
    vaf_tumor = np.where(
        somatic, purity * rng.uniform(0.2, 1.0, n_loci),
        np.where(germline, germ_af, 0.0),
    )
    vaf_normal = np.where(germline, germ_af, 0.0)
    pos = 1000 + 10 * np.arange(n_loci, dtype=np.int64)
    bases = np.array(list("ACGT"))
    ref_i = rng.integers(0, 4, n_loci)
    alt_i = (ref_i + rng.integers(1, 4, n_loci)) % 4
    variants = [
        VariantInfo(kind="snv", chrom=chrom, pos=int(p), ref_allele=bases[r],
                    alt_allele=bases[a])
        for p, r, a in zip(pos, ref_i, alt_i)
    ]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [
        _write_synth_sample(out_dir / f"{name}.obs", name, variants, vaf, rng,
                            min_depth, max_depth)
        for name, vaf in (("tumor", vaf_tumor), ("normal", vaf_normal))
    ]
    truth = {"somatic": pos[somatic], "germline": pos[germline]}
    return paths[0], paths[1], truth


def region_shards(paths, out_dir, sizes):
    """Split observation files into consecutive region shards: shard k holds
    the next ``sizes[k]`` loci of every file (one contig), rewritten with the
    port's ObservationReader / ObservationWriter under ``out_dir/shard<k>/``
    with the file's own name.  Returns one list of paths per shard, in the
    order of ``paths``."""
    from pathlib import Path

    from .calling.observations import ObservationReader, ObservationWriter

    readers = [ObservationReader(str(p)) for p in paths]
    shards = []
    try:
        for k, n in enumerate(sizes):
            d = Path(out_dir) / f"shard{k}"
            d.mkdir(parents=True, exist_ok=True)
            shard = []
            for p, r in zip(paths, readers):
                variants, counts, cols, dp = r.read_window(n)
                if len(variants) != n:
                    raise ValueError(f"{p}: shard {k} has {len(variants)} of {n} loci")
                dst = d / Path(p).name
                with ObservationWriter(str(dst), r.sample_name) as w:
                    w.write_window(variants, counts, cols, dp)
                shard.append(str(dst))
            shards.append(shard)
    finally:
        for r in readers:
            r.close()
    return shards


def synth_sample_observation_files(out_dir, sample_names, n_loci=200, seed=0,
                                   min_depth=20, max_depth=64, chrom="chr1"):
    """One observation file per sample of a scenario, for ``n_loci`` SNV
    candidates: a third of the loci are reference in every sample, the rest
    draw each sample's VAF from {0, 0.5, 1, U(0.05, 1)}.  Reads as in
    :func:`synth_observation_files`.  Returns {sample name: path}."""
    from pathlib import Path

    from .calling.variants import VariantInfo

    rng = np.random.default_rng(seed)
    S = len(sample_names)
    kind = rng.integers(0, 4, (n_loci, S))
    vafs = np.choose(kind, [np.zeros((n_loci, S)), np.full((n_loci, S), 0.5),
                            np.ones((n_loci, S)), rng.uniform(0.05, 1.0, (n_loci, S))])
    vafs[rng.random(n_loci) < 1 / 3] = 0.0
    bases = np.array(list("ACGT"))
    ref_i = rng.integers(0, 4, n_loci)
    alt_i = (ref_i + rng.integers(1, 4, n_loci)) % 4
    variants = [
        VariantInfo(kind="snv", chrom=chrom, pos=1000 + 10 * i,
                    ref_allele=bases[r], alt_allele=bases[a])
        for i, (r, a) in enumerate(zip(ref_i, alt_i))
    ]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return {
        name: _write_synth_sample(out_dir / f"{name}.obs", name, variants,
                                  vafs[:, si], rng, min_depth, max_depth)
        for si, name in enumerate(sample_names)
    }


def reference_observation_file(src, dst, n=None):
    """Re-encode the port's observation file ``src`` (its first ``n``
    records, or all) into the reference's v15 format at ``dst`` (``.bcf``
    or ``.vcf``) with ``ReferenceObservationWriter``: the observation files
    the reference's own ``varlociraptor preprocess`` writes.  The v15
    encoding is lossy (f16 fields, ``_mini_logprob``), so a call of ``dst``
    is compared only with another call of ``dst``.  Returns ``str(dst)``."""
    from .calling.observations import ObservationReader
    from .calling.ref_obs import ReferenceObservationWriter

    reader = ObservationReader(str(src))
    try:
        with ReferenceObservationWriter(str(dst), reader.sample_name) as w:
            for i, (variant, pileup) in enumerate(reader):
                if n is not None and i >= n:
                    break
                w.write_record(variant, pileup)
    finally:
        reader.close()
    return str(dst)
