"""The port's hand-written CUDA kernels on the card: K1 (csrc/ll_classes.cu),
K2, K3 and K4 (csrc/pairhmm_column.cu), each of K2-K4 at every tile, the
engine's grid contraction (csrc/lse_contract.cu), its star l2fc integral
(csrc/lfc_star.cu) and its event and MAP / AFD pass (csrc/assemble.cu).

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false.  On a machine with an NVIDIA card and nvcc:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: K1 against its plain torch version 5e-5 * max(1, |x|) with the
same finiteness (float32 logs, read sums in another order); K2, K3 and K4
against theirs 1e-4 * max(1, |x|) (float32 column sums in another order, the
D scan in another association), the same finiteness and -1e30 exactly where
the plain version gives it; the grid contraction against its plain version
2e-5 * max(1, |x|) with -inf in the same places (float32 exps and logs, the
sum over v in another order than the einsum's); the star l2fc integral
against its plain version within 2e-6 * |x| or 1e-4, whichever is larger,
with -inf in the same places and no NaN (float32 ex2.approx, the sum over
(g, ga, gb) in another order than the loop's); the event and MAP / AFD
pass's two kernels against their plain versions at LSE_TOL with -inf and
NaN alike, the MAP event and the top-K indices equal but at near ties
(bench_utils.assemble_mismatches), the deci-PHRED values apart by 1 only
near a half; the engine on the card against the engine on
the CPU at the engine tolerances of varlociraptor_tpu_torch/compare.py, in
tumor-normal and in chip_smoke.py phase (f)'s modes (--full-prior, l2fc,
cyclic contamination), and in the de novo trio under
--full-prior (table rows by locus, the trio loop over locus chunks); the
legacy per-WorkItem caller's VCF on the card
against the CPU's (compare_vcf_text); the CNV Viterbi's state path on the
card equal to the CPU's; the all-kinds world (bench_utils.KINDS_WORLD)
preprocessed on the card against the CPU kind by kind, each kind's first K2 /
K3 launch of another panel than 128 x 128 against the plain kernel, and a
testcase of each kind replayed on the card against the CPU (PHRED and AF
within 1e-3 * max(1, |x|), chip_smoke.py's WORLD_VCF_TOL for such loci);
the sharded engine on two shards of one card against engine.run, and the
sharded call against the single-device panels route (byte for byte) and
the CPU's sharded call.
"""

import math

import numpy as np
import pytest
import torch

from varlociraptor_tpu_torch.bench_utils import (
    ASSEMBLE_CASES,
    K1_EDGE_CASES,
    LFC_STAR_CASES,
    LSE_CONTRACT_CASES,
    PAIRHMM_TILE_WIDTHS,
    assemble_args,
    assemble_mismatches,
    cyclic_engine,
    engine_inputs,
    full_prior_table,
    k1_edge_rows,
    pairhmm_edge_items,
    pairhmm_items,
    pairhmm_shape_items,
    pairhmm_tile_items,
    l2fc_engine,
    lfc_star_args,
    lse_contract_args,
    rho_engine,
    TRIO_DENOVO_SCENARIO,
    scenario_engine,
    tumor_normal_engine,
)
from varlociraptor_tpu_torch.compare import compare_outputs
from varlociraptor_tpu_torch.estimation.alignment_properties import HopParams
from varlociraptor_tpu_torch.ops import assemble as asm
from varlociraptor_tpu_torch.ops import lfc_star as ls
from varlociraptor_tpu_torch.ops import ll_classes as k1
from varlociraptor_tpu_torch.ops import lse_contract as lc
from varlociraptor_tpu_torch.ops import pairhmm_column as phc

pytestmark = pytest.mark.cuda

TOL = 5e-5
# the grid contraction against its plain version: float32 exps and logs,
# the sum over v in another order than the einsum's
LSE_TOL = 2e-5
# the star l2fc integral against its plain version: the larger of the two
LFC_TOL_REL, LFC_TOL_ABS = 2e-6, 1e-4
PAIRHMM_TOL = 1e-4
# log gap params (t_mi, t_md, t_ii, t_dd): the default zero-extension model,
# and ONT-like finite extensions (tests/test_pallas_pairhmm.py)
GAP = np.array([math.log(2.8e-6), math.log(5.1e-6), -1e30, -1e30], np.float32)
GAP_ONT = np.log(np.array([5.1e-3, 4.2e-3, 0.35, 0.42])).astype(np.float32)
# homopolymer hop params as the estimator gives them: open == extend
HOP = HopParams(*([[math.log(0.05)] * 4] * 4))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _folded_rows(seed, N, D, U, dev):
    """K1 inputs with a fifth of the reads folded to (1, 1, 0) as masked."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.01, 1.0, (N, D))
    r = rng.uniform(0.01, 1.0, (N, D))
    m = rng.uniform(0.0, 0.1, (N, D))
    psa = rng.uniform(0.0, 1.0, (N, D))
    masked = rng.random((N, D)) < 0.2
    a[masked], r[masked], m[masked] = 1.0, 1.0, 0.0
    nu = rng.uniform(0.0, 1.0, U)
    kappa = np.zeros(U)
    nu[0], kappa[0] = 1.0, 1.0
    nu[-1] = 0.0
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    return [t(x) for x in (a, r, m, psa, nu, kappa)]


@pytest.mark.parametrize(
    "N,D,U",
    [(48, 24, 37), (4096, 64, 711), (1024, 128, 711), (100, 200, 5), (1, 1, 1)],
)
def test_k1_kernel_matches_plain(card, N, D, U):
    args = _folded_rows(N + D + U, N, D, U, card)
    n0 = k1.ll_classes.launches
    got = k1.ll_classes(*args)
    assert k1.ll_classes.launches == n0 + 1
    ref = k1.ll_classes_reference(*args)
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert g.shape == (N, U) and got.dtype == torch.float32
    fin = np.isfinite(r)
    assert np.array_equal(np.isfinite(g), fin)
    err = np.abs(g[fin] - r[fin]) / np.maximum(1.0, np.abs(r[fin]))
    assert err.max() <= TOL, err.max()


@pytest.mark.parametrize("name", K1_EDGE_CASES)
def test_k1_kernel_edge_cases(card, name):
    """Inputs that the kernel's exponent-split logs can get wrong: reads not
    a multiple of the group, several staged chunks, terms near and below the
    bottom of the normal range and zero terms, all-masked rows, one class
    and a class count that is not a multiple of the tile
    (bench_utils.k1_edge_rows)."""
    args = [torch.as_tensor(x, device=card) for x in k1_edge_rows(name)]
    got = k1.ll_classes(*args)
    ref = k1.ll_classes_reference(*args)
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert g.shape == r.shape
    fin = np.isfinite(r)
    assert np.array_equal(np.isfinite(g), fin)
    if name == "denormal_and_zero":
        assert not fin.all()  # the zero terms reach -inf
    err = np.abs(g[fin] - r[fin]) / np.maximum(1.0, np.abs(r[fin]))
    assert err.max() <= TOL, err.max()


def test_k1_wrapper_checks_its_inputs(card):
    a, r, m, psa, nu, kappa = _folded_rows(0, 64, 16, 8, card)
    n0 = k1.ll_classes.launches
    with pytest.raises(TypeError, match="float32"):
        k1.ll_classes(a.double(), r, m, psa, nu, kappa)
    with pytest.raises(ValueError, match="contiguous"):
        k1.ll_classes(a.t(), r, m, psa, nu, kappa)
    with pytest.raises(ValueError, match="shape"):
        k1.ll_classes(a, r[:, :8].contiguous(), m, psa, nu, kappa)
    with pytest.raises(ValueError):
        k1.ll_classes(a, r, m, psa, nu.cpu(), kappa)
    assert k1.ll_classes.launches == n0


@pytest.mark.parametrize("name", LSE_CONTRACT_CASES)
def test_lse_contract_kernel_matches_plain(card, name):
    """The grid contraction against its plain version on the card
    (bench_utils.lse_contract_args): the call's four shapes (the B = 8
    elimination with S expanded over B, a B = 1 slice of a slab, the swapped
    F), -inf rows and columns and a one-point class, branches in no class,
    more branches than classes and groups, and a grid larger than a block's
    shared memory."""
    F, S, table = lse_contract_args(name, card)
    n0 = lc.lse_contract.launches
    got = lc.lse_contract(F, S, table)
    assert lc.lse_contract.launches == n0 + 1
    ref = lc.lse_contract_reference(F, S, table.per)
    torch.cuda.synchronize()
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert g.shape == r.shape and got.dtype == torch.float32
    fin = np.isfinite(r)
    assert np.array_equal(np.isfinite(g), fin)
    assert np.array_equal(g[~fin], r[~fin])
    if name == "neg_inf":
        assert not fin.all()
    err = np.abs(g[fin] - r[fin]) / np.maximum(1.0, np.abs(r[fin]))
    assert err.max(initial=0.0) <= LSE_TOL, err.max()


def test_lse_contract_wrapper_checks_its_inputs(card):
    F, S, table = lse_contract_args("no_class", card, L=4)
    _, _, other = lse_contract_args("nb_gt_k", card, L=4)
    _, _, on_cpu = lse_contract_args("no_class", "cpu", L=4)
    n0 = lc.lse_contract.launches
    with pytest.raises(TypeError, match="float32"):
        lc.lse_contract(F.double(), S, table)
    with pytest.raises(ValueError, match="rank"):
        lc.lse_contract(F[0], S, table)
    with pytest.raises(ValueError, match="do not agree"):
        lc.lse_contract(F, S[..., :-1], table)
    with pytest.raises(ValueError, match="class table"):
        lc.lse_contract(F, S, other)
    with pytest.raises(ValueError, match="on cpu"):
        lc.lse_contract(F, S, on_cpu)
    assert lc.lse_contract.launches == n0


@pytest.mark.parametrize("name", LFC_STAR_CASES)
def test_lfc_star_kernel_matches_plain(card, name):
    """The star l2fc integral against its plain version on the card
    (bench_utils.lfc_star_args): the relapse_l2fc cell's branch [1024, 8,
    101, 101, 11], phase (f2)'s 101-point normal, a 1001 x 1001 mask at two
    loci, Ga != Gb, a one-point parent grid, a fully masked branch, -inf
    rows, and pairs whose peak the mask cuts (the kernel's exact redo)."""
    args = lfc_star_args(name, card)
    n0 = ls.lfc_star.launches
    got = ls.lfc_star(*args)
    assert ls.lfc_star.launches == n0 + 1
    ref = ls.lfc_star_reference(*args)
    torch.cuda.synchronize()
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert g.shape == r.shape and got.dtype == torch.float32
    fin = np.isfinite(r)
    assert not np.isnan(g).any()
    assert np.array_equal(np.isfinite(g), fin)
    assert np.array_equal(g[~fin], r[~fin])
    if name in ("masked", "neg_inf"):
        assert not fin.all()
    lim = np.maximum(LFC_TOL_REL * np.abs(r[fin]), LFC_TOL_ABS)
    err = np.abs(g[fin] - r[fin])
    assert (err <= lim).all(), (err / lim).max()


def test_lfc_star_wrapper_checks_its_inputs(card):
    pa, wa, pb, wb, lm, rp = lfc_star_args("ragged", card, L=4)
    n0 = ls.lfc_star.launches
    with pytest.raises(TypeError, match="float32"):
        ls.lfc_star(pa.double(), wa, pb, wb, lm, rp)
    with pytest.raises(ValueError, match="rank"):
        ls.lfc_star(pa[0], wa, pb, wb, lm, rp)
    with pytest.raises(ValueError, match="do not agree"):
        ls.lfc_star(pa, wa, pb, wb, lm.T, rp)
    with pytest.raises(ValueError, match="on cpu"):
        ls.lfc_star(pa, wa, pb, wb, lm.cpu(), rp)
    assert ls.lfc_star.launches == n0


def test_l2fc_window_on_the_card_runs_the_star_kernel(card):
    """One traced window of phase (f2)'s l2fc engine: one kernel launch a
    star branch, counted in ``lfc_star.launches`` and in the trace counter
    ``engine.lfc_star_launches``, and no plain loop step
    (``engine.lfc_steps`` 0)."""
    from torch.profiler import ProfilerActivity, profile

    from varlociraptor_tpu_torch import tracing

    engine = l2fc_engine(device=card)
    inputs = engine_inputs(engine, n_loci=24, depth=32, seed=6)
    engine.run(*inputs)  # warm-up, untraced
    log = tracing.Log()
    saved, tracing.LOG = tracing.LOG, log
    n0, engine.loop_steps = ls.lfc_star.launches, 0
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            engine.run(*inputs)
    finally:
        tracing.LOG = saved
    counts = {}
    for _, rec in log.records():
        if rec[6] is not None:
            counts[rec[0]] = counts.get(rec[0], 0) + rec[6]
    branches = len(engine._lfc_t)
    assert branches == 6
    assert ls.lfc_star.launches == n0 + branches
    assert counts["engine.lfc_star_launches"] == branches
    assert counts["engine.lfc_steps"] == 0 and engine.loop_steps == 0


@pytest.mark.parametrize("name", ASSEMBLE_CASES)
def test_assemble_kernels_match_plain(card, name):
    """The event and MAP / AFD pass's head and tail kernels against their
    plain versions on the card (bench_utils.assemble_args): the two cells'
    engines at 1024 loci, three components, a 1001-point grid, a two-point
    grid, one combination slot, exact ties in the events and densities,
    rows -inf throughout, events compiled to False, and 13,000 events and
    branches (past a block's default 48 KB of shared memory in both)."""
    tables, head, tail = assemble_args(name, card, seed=5)
    h0, t0 = asm.assemble_head.launches, asm.assemble_tail.launches
    got_head = asm.assemble_head(*head, tables)
    got_tail = asm.assemble_tail(*tail, tables)
    assert (asm.assemble_head.launches, asm.assemble_tail.launches) == (h0 + 1, t0 + 1)
    ref_head = asm.assemble_head_reference(*head, tables)
    ref_tail = asm.assemble_tail_reference(*tail, tables)
    torch.cuda.synchronize()
    for g, r in zip(got_head[:5] + got_tail, ref_head[:5] + ref_tail):
        assert g.shape == r.shape and g.dtype == r.dtype
    problems, _ = assemble_mismatches(tables, tail, got_head, ref_head, got_tail, ref_tail,
                                      LSE_TOL)
    assert not problems, problems


def test_assemble_wrappers_check_their_inputs(card):
    tables, head, tail = assemble_args("trio", card, L=8)
    bv, gates, n_art, n_combos, w = head
    d_own, U0, comp_of, marginal = tail
    cpu_tables = assemble_args("trio", "cpu", L=8)[0]
    h0, t0 = asm.assemble_head.launches, asm.assemble_tail.launches
    with pytest.raises(TypeError, match="float32"):
        asm.assemble_head(bv.double(), gates, n_art, n_combos, w, tables)
    with pytest.raises(ValueError, match="contiguous"):
        asm.assemble_head(bv.transpose(1, 2).contiguous().transpose(1, 2), gates, n_art,
                          n_combos, w, tables)
    with pytest.raises(ValueError, match="on cpu"):
        asm.assemble_head(bv, gates, n_art, n_combos, [w[0].cpu()] + w[1:], tables)
    with pytest.raises(ValueError, match="tables on cpu"):
        asm.assemble_head(bv, gates, n_art, n_combos, w, cpu_tables)
    with pytest.raises(ValueError, match="d_own"):
        asm.assemble_tail(d_own[:-1], U0, comp_of, marginal, tables)
    with pytest.raises(ValueError, match="contiguous"):
        asm.assemble_tail(d_own, U0, comp_of, torch.stack([marginal] * 2, 1)[:, 0], tables)
    with pytest.raises(ValueError, match="tables on cpu"):
        asm.assemble_tail(d_own, U0, comp_of, marginal, cpu_tables)
    assert (asm.assemble_head.launches, asm.assemble_tail.launches) == (h0, t0)


def test_engine_window_on_the_card_runs_the_assemble_kernels(card):
    """One traced tumor-normal window: the pass is one launch of each
    kernel, counted in ``engine.assemble_launches``, and its stream time in
    ``engine.assemble_stream_ns``, within the span ``engine.assemble``."""
    from torch.profiler import ProfilerActivity, profile

    from varlociraptor_tpu_torch import tracing

    _, engine = tumor_normal_engine(resolution=0.01, device=card)
    inputs = engine_inputs(engine, n_loci=64, depth=32, seed=6)
    engine.run(*inputs)  # warm-up, untraced
    log = tracing.Log()
    saved, tracing.LOG = tracing.LOG, log
    h0, t0 = asm.assemble_head.launches, asm.assemble_tail.launches
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            engine.run(*inputs)
    finally:
        tracing.LOG = saved
    counts, spans = {}, []
    for _, rec in log.records():
        if rec[6] is not None:
            counts[rec[0]] = counts.get(rec[0], 0) + rec[6]
        elif rec[0] == "engine.assemble":
            spans.append(rec)
    assert (asm.assemble_head.launches, asm.assemble_tail.launches) == (h0 + 1, t0 + 1)
    assert counts["engine.assemble_launches"] == 2
    assert len(spans) == 1 and counts["engine.assemble_stream_ns"] > 0


def test_engine_on_the_card_matches_the_cpu(card):
    _, gpu = tumor_normal_engine(resolution=0.01, device=card)
    _, cpu = tumor_normal_engine(resolution=0.01, device="cpu")
    inputs = engine_inputs(cpu, n_loci=96, depth=32, seed=5)
    n0, c0 = k1.ll_classes.launches, lc.lse_contract.launches
    a0 = asm.assemble_head.launches + asm.assemble_tail.launches
    got = gpu.run(*inputs)
    assert k1.ll_classes.launches == n0 + 2
    assert lc.lse_contract.launches == c0 + 4
    assert asm.assemble_head.launches + asm.assemble_tail.launches == a0 + 2
    ref = cpu.run(*inputs)
    problems, _ = compare_outputs(ref, got, grid_values=cpu.grid.values)
    assert not problems, problems[:5]


def test_sharded_engine_on_the_card_matches_run(card):
    """run_sharded over two shards on one card: K1 twice in each shard, every
    output equal to engine.run on the card; all_gather_rows in one process
    returns float64 rows through the card bit for bit."""
    from varlociraptor_tpu_torch.parallel.sharding import (
        all_gather_rows, locus_mesh, run_sharded,
    )

    _, gpu = tumor_normal_engine(resolution=0.01, device=card)
    inputs = engine_inputs(gpu, n_loci=97, depth=32, seed=7)
    ref = gpu.run(*inputs)
    mesh = locus_mesh([card] * 2)
    n0 = k1.ll_classes.launches
    got = run_sharded(gpu, mesh, *inputs)
    assert k1.ll_classes.launches == n0 + 4
    problems, _ = compare_outputs(ref, got, grid_values=gpu.grid.values)
    assert not problems, problems[:5]
    rows = np.random.default_rng(1).standard_normal((13, 2)) / 3.0
    assert all_gather_rows(rows, mesh).tobytes() == rows.tobytes()


def test_sharded_call_on_the_card_equals_the_panels_route(card, tmp_path, monkeypatch):
    """call_generic(mesh=...) over two shards of the card equals the panels
    route of a one-shard mesh byte for byte, and the CPU's sharded call
    within compare_vcf_text."""
    from varlociraptor_tpu_torch.bench_utils import synth_observation_files
    from varlociraptor_tpu_torch.calling.call import call_generic
    from varlociraptor_tpu_torch.compare import compare_vcf_text
    from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
    from varlociraptor_tpu_torch.parallel.sharding import locus_mesh

    tumor, normal, _ = synth_observation_files(tmp_path, n_loci=300, seed=4)
    obs = {"tumor": tumor, "normal": normal}
    monkeypatch.delenv("VLT_LEGACY_CALL", raising=False)
    sc = tumor_normal_scenario(0.75)
    paths = {k: tmp_path / f"{k}.vcf" for k in ("mesh", "panels", "cpu")}
    call_generic(sc, obs, str(paths["mesh"]), mesh=locus_mesh([card, card]), device=card)
    call_generic(sc, obs, str(paths["cpu"]), mesh=locus_mesh(["cpu"] * 2), device="cpu")
    call_generic(sc, obs, str(paths["panels"]), mesh=locus_mesh([card]), device=card)
    assert paths["mesh"].read_bytes() == paths["panels"].read_bytes()
    problems, _ = compare_vcf_text(paths["cpu"].read_text(), paths["mesh"].read_text())
    assert not problems, problems[:5]


def _mode_engine(name, device):
    """(engine, joint prior table or None) of chip_smoke.py phase (f)'s
    modes: (f1) tumor-normal with --full-prior, (f2) the l2fc scenario,
    (f3) the three-sample contamination cycle; and the cycle with a tree
    node, whose cyclic reducer runs the grid contraction."""
    if name == "full_prior":
        scenario, engine = tumor_normal_engine(resolution=0.01, device=device)
        return engine, full_prior_table(scenario, engine)[0]
    if name == "l2fc":
        return l2fc_engine(device=device), None
    if name == "cyclic_tree":
        return rho_engine(device=device), None
    return cyclic_engine(device=device), None


@pytest.mark.parametrize("name,k1_per_call,contractions_per_call", [
    ("full_prior", 2, 3), ("l2fc", 3, 10), ("cyclic", 3, 0), ("cyclic_tree", 4, 6)])
def test_engine_modes_on_the_card_match_the_cpu(card, name, k1_per_call,
                                                contractions_per_call):
    gpu, table = _mode_engine(name, card)
    cpu, _ = _mode_engine(name, "cpu")
    L = 24
    inputs = engine_inputs(cpu, n_loci=L, depth=32, seed=6)
    pj = None if table is None else table[None]
    idx = None if table is None else np.zeros(L, np.int64)
    n0, c0, s0 = k1.ll_classes.launches, lc.lse_contract.launches, ls.lfc_star.launches
    h0, t0 = asm.assemble_head.launches, asm.assemble_tail.launches
    got = gpu.run(*inputs, ln_prior_joint=pj, ln_prior_idx=idx)
    # the event and MAP / AFD pass: one launch of each of its kernels
    assert (asm.assemble_head.launches, asm.assemble_tail.launches) == (h0 + 1, t0 + 1)
    assert k1.ll_classes.launches == n0 + k1_per_call
    assert lc.lse_contract.launches == c0 + contractions_per_call
    # the star l2fc integral: one launch a branch of the l2fc scenario
    assert ls.lfc_star.launches == s0 + (len(gpu._lfc_t) if name == "l2fc" else 0)
    ref = cpu.run(*inputs, ln_prior_joint=pj, ln_prior_idx=idx)
    problems, _ = compare_outputs(ref, got, grid_values=cpu.grid.values)
    assert not problems, problems[:5]


def test_trio_full_prior_on_the_card_matches_the_cpu(card, monkeypatch):
    """The de novo trio (``bench_utils.TRIO_DENOVO_SCENARIO``: the
    Mendelian joint prior, the trio loop of ``_full_prior_T``) at resolution
    0.05, its table on the card and each locus's row by index, the loop cut
    into chunks of a few loci: the CPU's outputs."""
    from varlociraptor_tpu_torch.ops import posterior

    doc = TRIO_DENOVO_SCENARIO
    scenario, gpu = scenario_engine(doc, 0.05, device=card, all_uniform_prior=False)
    _, cpu = scenario_engine(doc, 0.05, device="cpu", all_uniform_prior=False)
    table = full_prior_table(scenario, cpu)[0][None]
    L = 16
    inputs = engine_inputs(cpu, n_loci=L, depth=32, seed=7)
    idx = np.zeros(L, np.int64)
    monkeypatch.setattr(posterior, "_FULL_PRIOR_SLAB_BYTES", 5 * 2**20)
    got = gpu.run(*inputs, ln_prior_joint=gpu.upload_prior_tables(table), ln_prior_idx=idx)
    ref = cpu.run(*inputs, ln_prior_joint=table, ln_prior_idx=idx)
    problems, _ = compare_outputs(ref, got, grid_values=cpu.grid.values)
    assert not problems, problems[:5]


def test_legacy_call_on_the_card_matches_the_cpu(card, tmp_path, monkeypatch):
    """The legacy per-WorkItem caller (VLT_LEGACY_CALL=1): K1 and the event
    and MAP / AFD pass's kernels launch in every ``call_batch`` (two K1 and
    one head and one tail per engine call, one engine call per 64-locus
    batch) and the VCF equals the CPU's within compare_vcf_text."""
    from varlociraptor_tpu_torch.bench_utils import synth_observation_files
    from varlociraptor_tpu_torch.calling.call import DEFAULT_BATCH, call_generic
    from varlociraptor_tpu_torch.compare import compare_vcf_text
    from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario

    n_loci = 150
    tumor, normal, _ = synth_observation_files(tmp_path, n_loci=n_loci, seed=4)
    obs = {"tumor": tumor, "normal": normal}
    monkeypatch.setenv("VLT_LEGACY_CALL", "1")
    n0 = k1.ll_classes.launches
    h0, t0 = asm.assemble_head.launches, asm.assemble_tail.launches
    assert call_generic(tumor_normal_scenario(0.75), obs, str(tmp_path / "gpu.vcf"),
                        device=card) == n_loci
    assert k1.ll_classes.launches - n0 == 2 * -(-n_loci // DEFAULT_BATCH)
    assert asm.assemble_head.launches - h0 == asm.assemble_tail.launches - t0 == -(
        -n_loci // DEFAULT_BATCH)
    call_generic(tumor_normal_scenario(0.75), obs, str(tmp_path / "cpu.vcf"), device="cpu")
    problems, _ = compare_vcf_text((tmp_path / "cpu.vcf").read_text(),
                                   (tmp_path / "gpu.vcf").read_text())
    assert not problems, problems[:5]


def test_viterbi_on_the_card_equals_the_cpu(card):
    from varlociraptor_tpu_torch.calling.cnvs import viterbi

    rng = np.random.default_rng(8)
    obs = rng.normal(-20.0, 8.0, (500, 221))
    obs[:, 7] = obs[:, 3]  # equal maxima: the first index wins on both
    obs[rng.random(obs.shape) < 0.05] = -np.inf
    for mbf in (1.01, 1e3):
        assert np.array_equal(viterbi(obs, mbf, device=card),
                              viterbi(obs, mbf, device="cpu"))


def _pairhmm_sets():
    sets = {"synth": pairhmm_items(21, 3), "synth11": pairhmm_items(21, 11),
            "shape_160x100": pairhmm_shape_items(256, 160, 100, seed=1)}
    sets.update(pairhmm_edge_items())
    return sets


@pytest.mark.parametrize("general", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("name", sorted(_pairhmm_sets()))
def test_pairhmm_kernel_matches_plain(card, general, name):
    alleles, reads, quals = _pairhmm_sets()[name]
    gap = GAP_ONT if general else GAP
    args, n, _, _ = phc.pack_exact_batch(alleles, reads, quals, gap)
    if general:
        args = args[:5] + (phc.general_coef(gap),)
    dev_args = phc.to_device(args, card)
    fn = phc.general_forward if general else phc.exact_forward
    ref_fn = phc.general_forward_reference if general else phc.exact_forward_reference
    n0 = fn.launches
    got = fn(*dev_args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    ref = ref_fn(*dev_args)
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert g.shape == (n,) and got.dtype == torch.float32
    assert np.array_equal(np.isfinite(g), np.isfinite(r))
    assert np.array_equal(g == -1e30, r == -1e30)
    ok = r > -1e30
    err = np.abs(g[ok] - r[ok]) / np.maximum(1.0, np.abs(r[ok]))
    assert np.all(err <= PAIRHMM_TOL), (name, err.max())
    # the whole item path: pack, kernel, empty-read mask
    items = phc.forward_items(alleles, reads, quals, gap, card, general)
    cpu = phc.forward_items(alleles, reads, quals, gap, "cpu", general)
    assert np.array_equal(items == -1e30, cpu == -1e30)
    ok = cpu > -1e30
    assert np.all(np.abs(items[ok] - cpu[ok]) <= PAIRHMM_TOL * np.maximum(1, np.abs(cpu[ok])))


def _against_plain(kind, alleles, reads, quals, card, tile=None):
    """K2 (``exact``, the default gap model), K3 (``general``, ONT-like
    finite extensions) or K4 (``positional``, those with hop rates of 0.05
    inside runs) at ``tile`` (default: the kernel's policy) against its
    plain version on the card: the same finiteness and -1e30 items,
    PAIRHMM_TOL."""
    if kind == "positional":
        dev_args = phc.positional_args(alleles, reads, quals, GAP_ONT, HOP, card)
    else:
        args, _, _, _ = phc.pack_exact_batch(alleles, reads, quals,
                                             GAP if kind == "exact" else GAP_ONT)
        if kind == "general":
            args = args[:5] + (phc.general_coef(GAP_ONT),)
        dev_args = phc.to_device(args, card)
    got = getattr(phc, f"{kind}_forward")(*dev_args, tile=tile)
    torch.cuda.synchronize()
    ref = getattr(phc, f"{kind}_forward_reference")(*dev_args)
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert g.shape == (len(alleles),)
    assert np.array_equal(np.isfinite(g), np.isfinite(r))
    assert np.array_equal(g == -1e30, r == -1e30)
    ok = r > -1e30
    err = np.abs(g[ok] - r[ok]) / np.maximum(1.0, np.abs(r[ok]))
    assert np.all(err <= PAIRHMM_TOL), (tile, err.max())


def _every_tile(kind, tile, card):
    """One instantiated tile, forced through the C entry, on the widest tile
    set it covers and on the mixed read lengths where it covers them."""
    sets = pairhmm_tile_items()
    widths = [X for X in PAIRHMM_TILE_WIDTHS if X <= tile[0] * tile[1]]
    _against_plain(kind, *sets[f"width_{max(widths)}"], card, tile=tile)
    if tile[0] * tile[1] >= 128:
        _against_plain(kind, *sets["mixed_rlen_in_warp"], card, tile=tile)
        _against_plain(kind, *sets["alen_not_multiple_of_rows"], card, tile=tile)


def _entry_refuses(fn_name, dev_args):
    for tile in ((8, 8), (5, 32)):  # covers 64 rows; no such instantiation
        with pytest.raises(RuntimeError, match="CUDA error"):
            phc._launch(fn_name, *dev_args, tile=tile)


@pytest.mark.parametrize("name", sorted(pairhmm_tile_items()))
def test_k2_tile_sets_match_plain(card, name):
    """K2's tiled layout on reads of 1, 4, 37 and 100 bases in one warp,
    allele lengths off the rows per lane, and panel widths 32 to 1056."""
    _against_plain("exact", *pairhmm_tile_items()[name], card)


@pytest.mark.parametrize("tile", phc.GENERAL_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_k2_every_tile_matches_plain(card, tile):
    _every_tile("exact", tile, card)


def test_k2_entry_refuses_a_tile_that_does_not_take_the_panel(card):
    alleles, reads, quals = pairhmm_tile_items()["width_128"]
    args, *_ = phc.pack_exact_batch(alleles, reads, quals, GAP)
    _entry_refuses("vlt_pairhmm_exact", phc.to_device(args, card))


@pytest.mark.parametrize("name", sorted(pairhmm_tile_items()))
def test_k3_tile_sets_match_plain(card, name):
    """K3's tiled layout on reads of 1, 4, 37 and 100 bases in one warp,
    allele lengths off the rows per lane, and panel widths 32 to 1056."""
    _against_plain("general", *pairhmm_tile_items()[name], card)


@pytest.mark.parametrize("tile", phc.GENERAL_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_k3_every_tile_matches_plain(card, tile):
    _every_tile("general", tile, card)


def test_k3_entry_refuses_a_tile_that_does_not_take_the_panel(card):
    alleles, reads, quals = pairhmm_tile_items()["width_128"]
    args, *_ = phc.pack_exact_batch(alleles, reads, quals, GAP_ONT)
    _entry_refuses("vlt_pairhmm_general",
                   phc.to_device(args[:5] + (phc.general_coef(GAP_ONT),), card))


def test_pairhmm_wrapper_checks_its_inputs(card):
    alleles, reads, quals = pairhmm_items(8, 3)
    args, *_ = phc.pack_exact_batch(alleles, reads, quals, GAP)
    a, r, q, al, rl, coef = phc.to_device(args, card)
    n0 = phc.exact_forward.launches
    with pytest.raises(TypeError, match="int32"):
        phc.exact_forward(a, r, q, al.long(), rl, coef)
    with pytest.raises(ValueError, match="coef"):
        phc.exact_forward(a, r, q, al, rl, torch.zeros(7, device=card))
    with pytest.raises(ValueError):
        phc.exact_forward(a, r, q, al.cpu(), rl, coef)
    with pytest.raises(ValueError, match="does not take"):
        phc.exact_forward(a, r, q, al, rl, coef, tile=(5, 32))
    with pytest.raises(ValueError, match="does not take"):
        phc.exact_forward(a, r, q, al, rl, coef, tile=(8, 16))  # 128 rows of 192
    assert phc.exact_forward.launches == n0


@pytest.mark.parametrize("name", sorted(_pairhmm_sets()))
def test_positional_kernel_matches_plain(card, name):
    """K4 against its plain version on the card (ONT-like base rates, hop
    rates of 0.05 inside runs), and the whole item path against the CPU."""
    alleles, reads, quals = _pairhmm_sets()[name]
    args = phc.positional_args(alleles, reads, quals, GAP_ONT, HOP, card)
    n0 = phc.positional_forward.launches
    got = phc.positional_forward(*args)
    torch.cuda.synchronize()
    assert phc.positional_forward.launches == n0 + 1
    ref = phc.positional_forward_reference(*args)
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    assert g.shape == (len(alleles),) and got.dtype == torch.float32
    assert np.array_equal(np.isfinite(g), np.isfinite(r))
    assert np.array_equal(g == -1e30, r == -1e30)
    ok = r > -1e30
    err = np.abs(g[ok] - r[ok]) / np.maximum(1.0, np.abs(r[ok]))
    assert np.all(err <= PAIRHMM_TOL), (name, err.max())
    items = phc.forward_items(alleles, reads, quals, GAP_ONT, card, True, hop=HOP)
    cpu = phc.forward_items(alleles, reads, quals, GAP_ONT, "cpu", True, hop=HOP)
    assert np.array_equal(items == -1e30, cpu == -1e30)
    ok = cpu > -1e30
    assert np.all(np.abs(items[ok] - cpu[ok]) <= PAIRHMM_TOL * np.maximum(1, np.abs(cpu[ok])))


@pytest.mark.parametrize("name", sorted(pairhmm_tile_items()))
def test_k4_tile_sets_match_plain(card, name):
    """K4's tiled layout on the sets of K3's: reads of 1, 4, 37 and 100
    bases in one warp, allele lengths off the rows per lane, and panel
    widths 32 to 1056."""
    _against_plain("positional", *pairhmm_tile_items()[name], card)


@pytest.mark.parametrize("tile", phc.GENERAL_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_k4_every_tile_matches_plain(card, tile):
    _every_tile("positional", tile, card)


def test_k4_entry_refuses_a_tile_that_does_not_take_the_panel(card):
    alleles, reads, quals = pairhmm_tile_items()["width_128"]
    _entry_refuses("vlt_pairhmm_positional",
                   phc.positional_args(alleles, reads, quals, GAP_ONT, HOP, card))


def test_positional_wrapper_checks_its_inputs(card):
    alleles, reads, quals = pairhmm_items(8, 3)
    a, r, q, al, rl, io, ie, do, de = phc.positional_args(alleles, reads, quals, GAP_ONT,
                                                          HOP, card)
    n0 = phc.positional_forward.launches
    with pytest.raises(TypeError, match="float32"):
        phc.positional_forward(a, r, q, al, rl, io.double(), ie, do, de)
    with pytest.raises(ValueError, match="do must be"):
        phc.positional_forward(a, r, q, al, rl, io, ie, io, de)
    with pytest.raises(ValueError, match="contiguous"):
        phc.positional_forward(a, r, q, al, rl, io, ie, do[:, ::2], de)
    with pytest.raises(ValueError):
        phc.positional_forward(a, r, q, al, rl, io, ie, do, de.cpu())
    assert phc.positional_forward.launches == n0


@pytest.fixture(scope="module")
def kinds_world(tmp_path_factory):
    """bench_utils.KINDS_WORLD with its normal's estimate (skips without a
    card before building anything)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    from varlociraptor_tpu_torch.bench_utils import KINDS_WORLD, synth_preprocess_world
    from varlociraptor_tpu_torch.estimation.alignment_properties import estimate
    from varlociraptor_tpu_torch.io.bam import BamReader
    from varlociraptor_tpu_torch.io.fasta import FastaBuffer

    w = synth_preprocess_world(tmp_path_factory.mktemp("kinds"), **KINDS_WORLD)
    w["props"] = estimate(BamReader(w["normal"]), reference=FastaBuffer(w["fasta"])).to_json()
    return w


def _kind_subset(w, kind, path):
    """The world's candidate records of one kind (all of a BND group's)."""
    from varlociraptor_tpu_torch.calling.variants import collect_variants
    from varlociraptor_tpu_torch.io.vcf import open_variant_file

    lines = open(w["candidates"]).read().splitlines()
    keep = [ln for ln in lines if ln.startswith("#")]
    recs = list(open_variant_file(w["candidates"]))
    body = [ln for ln in lines if not ln.startswith("#")]
    keep += [ln for ln, rec in zip(body, recs)
             if any(i.kind == kind for i in collect_variants(rec))]
    path.write_text("\n".join(keep) + "\n")
    return str(path)


def test_kinds_preprocess_on_the_card_matches_the_cpu(card, kinds_world, tmp_path):
    """The all-kinds world preprocessed on the card (64 loci per launch)
    against the CPU at the same chunk (so the same alignment-property
    ratchet), each kind compared alone (compare_observation_files)."""
    from varlociraptor_tpu_torch.bench_utils import OTHER_KINDS
    from varlociraptor_tpu_torch.calling.preprocess import PreprocessOptions, preprocess
    from varlociraptor_tpu_torch.compare import compare_observation_files
    from varlociraptor_tpu_torch.estimation.alignment_properties import AlignmentProperties

    w = kinds_world
    n0 = phc.exact_forward.launches + phc.general_forward.launches
    for sample in ("tumor", "normal"):
        out = {}
        for dev in (card, "cpu"):
            out[dev] = tmp_path / f"{sample}.{dev}.obs"
            preprocess(w["candidates"], w[sample], w["fasta"], str(out[dev]),
                       sample_name=sample,
                       alignment_properties=AlignmentProperties.from_json(w["props"]),
                       options=PreprocessOptions(log_mode="silent", device_chunk=64),
                       device=dev)
        for kind in OTHER_KINDS + ("deletion", "insertion", "snv"):
            problems, info = compare_observation_files(out["cpu"], out[card], kinds={kind})
            assert not problems, (sample, kind, problems)
            assert info["records"] > 0
    assert phc.exact_forward.launches + phc.general_forward.launches > n0


@pytest.mark.parametrize("kind", ["mnv", "none", "inversion", "duplication", "replacement",
                                  "breakend", "methylation"])
def test_kind_first_other_panel_matches_plain(card, kinds_world, tmp_path, kind):
    """The tumor's records of one kind on the card: the first K2 / K3
    launch whose panel is not 128 x 128 against the plain kernel on the
    same inputs, items below -100 nats in both excepted (chip_smoke.py's
    FORWARD_FLOOR).  The SV and replacement kinds must launch."""
    from varlociraptor_tpu_torch.calling.preprocess import PreprocessOptions, preprocess
    from varlociraptor_tpu_torch.estimation.alignment_properties import AlignmentProperties

    w = kinds_world
    seen = []

    def hook(stage, fn_name, allele, read, tensors, tile):
        if stage == "enter":
            seen.append((fn_name, allele, read, tensors, tile))

    phc.launch_hook = hook
    try:
        preprocess(_kind_subset(w, kind, tmp_path / "subset.vcf"), w["tumor"], w["fasta"],
                   str(tmp_path / "subset.obs"), sample_name="tumor",
                   alignment_properties=AlignmentProperties.from_json(w["props"]),
                   options=PreprocessOptions(log_mode="silent"), device=card)
    finally:
        phc.launch_hook = None
    other = [s for s in seen if (s[1].shape[1], s[2].shape[1]) != (128, 128)]
    if kind in ("inversion", "duplication", "replacement", "breakend"):
        assert seen, kind  # realigned: the pair-HMM ran
    for fn_name, allele, read, tensors, tile in other[:1]:
        ref_fn = (phc.exact_forward_reference if fn_name == "vlt_pairhmm_exact"
                  else phc.general_forward_reference)
        got = phc._launch(fn_name, allele, read, *tensors, tile=tile).cpu().numpy()
        ref = ref_fn(allele, read, *tensors).cpu().numpy()
        assert np.array_equal(np.isfinite(got), np.isfinite(ref))
        assert np.array_equal(got <= -1e30, ref <= -1e30)
        # chip_smoke.FORWARD_FLOOR: a read that aligns nowhere (both values
        # below -100 nats) sits at float32's underflow edge
        held = (ref > -1e30) & ~((got < -100.0) & (ref < -100.0))
        err = np.abs(got[held] - ref[held]) / np.maximum(1.0, np.abs(ref[held]))
        assert err.max() <= PAIRHMM_TOL, (kind, allele.shape, err.max())


@pytest.mark.parametrize("kind", ["mnv", "none", "inversion", "duplication", "replacement",
                                  "breakend", "methylation"])
def test_testcase_replay_on_the_card_matches_the_cpu(card, kinds_world, tmp_path, kind):
    """One testcase of the kind, captured with the port's CLI from the
    card's observation files, replayed with ``Testcase.run`` on the card
    and on the CPU: the calls agree (compare_vcf_text), and the card's
    replay launches K1."""
    import yaml

    from varlociraptor_tpu_torch import cli
    from varlociraptor_tpu_torch.compare import compare_vcf_text
    from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
    from varlociraptor_tpu_torch.testcase import Testcase

    w = kinds_world
    obs = {}
    for sample in ("tumor", "normal"):
        obs[sample] = str(tmp_path / f"{sample}.obs")
        assert cli.run(["preprocess", "variants", w["fasta"], "--bam", w[sample],
                        "--candidates", w["candidates"], "--output", obs[sample],
                        "--sample-name", sample]) == 0
    scenario = tmp_path / "scenario.yaml"
    scenario.write_text(yaml.safe_dump(tumor_normal_scenario(0.75).doc))
    t = w["truth"]["kinds"][kind]
    planted = t.get("germline", []) + t.get("somatic", []) + t.get("methylated", [])
    prefix = tmp_path / "testcase"
    assert cli.run(["call", "variants", "generic", "--scenario", str(scenario), "--obs",
                    f"tumor={obs['tumor']}", f"normal={obs['normal']}", "--output",
                    str(tmp_path / "calls.vcf"), "--testcase-locus",
                    f"chr1:{min(planted or t['decoy']) + 1}",
                    "--testcase-prefix", str(prefix)]) == 0
    n0 = k1.ll_classes.launches
    records, _ = Testcase(prefix).run(tmp_path / "gpu")
    assert records and k1.ll_classes.launches > n0
    Testcase(prefix).run(tmp_path / "cpu", device="cpu")
    problems, _ = compare_vcf_text((tmp_path / "cpu" / "calls.vcf").read_text(),
                                   (tmp_path / "gpu" / "calls.vcf").read_text(), rel_tol=1e-3)
    assert not problems, (kind, problems)


def _wavefront_sets():
    from varlociraptor_tpu_torch.bench_utils import semiglobal_distances

    sets = {name: (*items, None) for name, items in pairhmm_edge_items().items()
            if name != "long_allele"}
    a, r, q = pairhmm_shape_items(256, 128, 100, seed=7)
    sets["shape_128"] = (a, r, q, None)
    sets["shape_128_banded"] = (a, r, q, [int(d) + 4 for d in semiglobal_distances(a, r)])
    a, r, q = pairhmm_items(21, 3)
    sets["synth_banded"] = (a, r, q, [int(d) + 4 for d in semiglobal_distances(a, r)])
    return sets


@pytest.mark.parametrize("flavour", ["banded", "positional", "hop"])
@pytest.mark.parametrize("name", sorted(_wavefront_sets()))
def test_wavefront_kernel_matches_plain(card, flavour, name):
    """The wavefront kernel (csrc/pairhmm_wavefront.cu) of each flavour
    against its plain version on the card, with and without the realigner's
    band (edit distance + 4): -1e30 alike, the rest within 1e-4 * max(1,
    |x|); the item path on the card against the CPU."""
    from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf

    alleles, reads, quals, dists = _wavefront_sets()[name]
    hop = None if flavour == "banded" else HOP
    got_flavour, args = pwf.wavefront_args(alleles, reads, quals, dists, GAP_ONT, card,
                                           hop=hop, hop_states=flavour == "hop")
    assert got_flavour == flavour
    fn = pwf.WRAPPERS[flavour]
    n0 = fn.launches
    g = fn(*args).cpu().numpy()
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    r = pwf.reference_of(flavour, args).cpu().numpy()
    assert np.array_equal(g == -1e30, r == -1e30) and np.isfinite(g).all()
    ok = r > -1e30
    assert np.all(np.abs(g[ok] - r[ok]) <= PAIRHMM_TOL * np.maximum(1.0, np.abs(r[ok])))
    gpu = pwf.forward_items(alleles, reads, quals, dists, GAP_ONT, card, hop=hop,
                            hop_states=flavour == "hop")
    cpu = pwf.forward_items(alleles, reads, quals, dists, GAP_ONT, "cpu", hop=hop,
                            hop_states=flavour == "hop")
    ok = cpu > -1e30
    assert np.array_equal(gpu == -1e30, cpu == -1e30)
    assert np.all(np.abs(gpu[ok] - cpu[ok]) <= PAIRHMM_TOL * np.maximum(1, np.abs(cpu[ok])))


def test_wavefront_wrapper_checks_its_inputs(card):
    from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf

    alleles, reads, quals = pairhmm_items(8, 3)
    _, (a, al, r, m, rl, g, me) = pwf.wavefront_args(alleles, reads, quals, None, GAP_ONT,
                                                     card)
    n0 = pwf.banded_forward.launches
    with pytest.raises(TypeError, match="float32"):
        pwf.banded_forward(a, al, r, m.double(), rl, g, me)
    with pytest.raises(ValueError, match="gaps must be"):
        pwf.banded_forward(a, al, r, m, rl, m[0], me)
    with pytest.raises(ValueError, match="contiguous"):
        pwf.banded_forward(a, al, r[:, ::2], m, rl, g, me)
    with pytest.raises(ValueError):
        pwf.banded_forward(a, al, r, m, rl, g, me.cpu())
    assert pwf.banded_forward.launches == n0
