#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``varlociraptor_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``varlociraptor_tpu_torch/csrc``
with nvcc (sm_90a, one process per source), then runs phases (a) to (k), each
printing one JSON line (phase (k) two; each with ``script_s``, the seconds
since the start).  It refuses every import of ``jax``, ``jaxlib`` and
the JAX package ``varlociraptor_tpu``, in its own process by an import hook
and in every Python process it starts through
``scripts/torch_no_jax/sitecustomize.py`` on ``PYTHONPATH``:

  (a) kernel_vs_plain  K1 against its plain torch version on the card, at the
                       shapes the engine gives it (the bench size and the
                       call CLI's window, with their bounds), at small edge
                       shapes and on the edge sets of
                       ``bench_utils.k1_edge_rows`` (3 and 256 reads, terms
                       near and below the bottom of the normal range, zero
                       terms, all-masked rows, 1 and 129 classes); both
                       timed with CUDA events after a warm-up.
  (a') pairhmm_vs_plain
                       K2 and K3 against their plain torch versions on the
                       card: 4096 x 160 x 100, 16384 x 256 x 150 and the K2
                       and K3 main-path shapes (K2_MAIN_SHAPE,
                       K3_MAIN_SHAPE) items (allele x read), the ragged
                       _synth set, the edge sets (empty read, N / lowercase,
                       read longer than its allele, 250-base low-quality
                       reads, the long deletion chain, alleles over 1024
                       bases) and the tile sets (reads of 1-100 bases in
                       one warp, allele lengths off the rows per lane,
                       panel widths 32-1056); each case names the kernel's
                       tile; the four shapes timed with CUDA events.
  (a'') positional_vs_plain
                       K4 against its plain torch version on the card, on the
                       sets of (a') and at K4's main-path shape
                       (K4_MAIN_SHAPE), with ONT-like base gap rates and hop
                       rates of 0.05 for every base inside homopolymer runs
                       (the gap panels built on the card); each case names
                       K4's tile; timed with CUDA events.
  (a''') contraction_vs_plain
                       the engine's grid contraction (csrc/lse_contract.cu)
                       against its plain version on the card, on every case
                       of ``bench_utils.lse_contract_args``: the call's
                       shapes (F [1024, 8, 101, 15] with S expanded over B,
                       a B = 1 slice of a slab, the swapped [1024, 1, 15,
                       101]), -inf rows and columns, branches in no class,
                       more branches than classes, and Gv = Gu = 1001 (-inf
                       alike, LC_TOL); the call's shapes and the large grid
                       timed with CUDA events beside their bound, and a
                       window's four summed.
  (a'''') lfc_star_vs_plain
                       the engine's star l2fc integral (csrc/lfc_star.cu)
                       against its plain version on the card, on every case
                       of ``bench_utils.lfc_star_args``: the relapse_l2fc
                       cell's branch [1024, 8, 101, 101, 11], phase (f2)'s
                       101-point normal, a 1001 x 1001 mask, Ga != Gb, a
                       one-point parent grid, a fully masked branch, -inf
                       rows, and pairs whose peak the mask cuts (-inf
                       alike, within LFC_TOL_REL x |x| or LFC_TOL_ABS); the
                       cell's and (f2)'s shapes timed with CUDA events
                       beside ``portbench/lib/roofline_lfc.lfc_roofline``'s
                       bound (the exponentials) and the plain version.
  (a''''') assemble_vs_plain
                       the engine's event and MAP / AFD pass, its head and
                       tail kernels (csrc/assemble.cu), against their plain
                       versions on the card, on every case of
                       ``bench_utils.assemble_args`` (the two cells' engines
                       at 1024 loci, three components, a 1001-point grid, a
                       two-point grid, one combination slot, exact ties,
                       -inf rows, events compiled to False;
                       ``bench_utils.assemble_mismatches`` at LC_TOL); the
                       two cells' shapes and the 1001-point grid timed with
                       CUDA events beside their bytes bound (inputs read
                       once, outputs written once, at 3.35 TB/s) and the
                       plain versions.
  (b) engine           the tumor-normal engine (resolution 0.01) on 32768
                       synthetic loci at depth 64, every output copied to the
                       host; K1 must launch twice per call, the contraction
                       four times and the assemble head and tail once each;
                       the first 1024 loci
                       are re-run with the plain version on the card and every
                       output compared.
  (c) cli              100,000 synthetic tumor/normal loci through
                       ``call variants tumor-normal --device cuda`` and
                       ``filter-calls control-fdr``; the first 2,000 loci are
                       re-called with ``--device cpu`` and the VCFs compared.
  (d) preprocess       a 2 Mb tumor/normal world (30x, 2x100 bp, 1,500 planted
                       indels and 500 decoys; simulated in a process of its
                       own while phases (a)-(c) run, as is (e)'s) through ``estimate
                       alignment-properties``, ``preprocess variants --device
                       cuda`` (both samples), a re-run of the first 200
                       normal candidates with the other gap model (so that K2
                       and K3 both launch), a ``--device cpu`` re-preprocess of
                       the first 192 loci of each sample (compared), ``call
                       variants tumor-normal --device cuda`` and
                       ``filter-calls control-fdr``; the pair-HMM kernels'
                       device time (events around the library call alone,
                       and around the whole launch helper), K2's and K3's
                       launches by panel shape and tile, and their first 8
                       launches re-timed warm (their inputs saved to
                       build/chip_smoke/k2_main_launches.pt and
                       k3_main_launches.pt).
  (e) homopolymer      the same at full width with the world's homopolymer
                       profile (runs of 5-12 bases, half of the indels as
                       run-length changes, reads that slip in runs):
                       ``estimate`` (finite hop params for all four bases),
                       ``preprocess variants --pairhmm-mode homopolymer
                       --device cuda`` (both samples; K4 launches, K2 and K3
                       do not), K4's launches by panel shape and tile and its
                       first 8 launches re-timed warm (their inputs saved to
                       build/chip_smoke/homopolymer/k4_main_launches.pt), the
                       192-locus ``--device cpu`` re-preprocess (compared),
                       call and FDR.
  (f) engine_modes     the engine's remaining modes at resolution 0.01, depth
                       64: (f1) tumor-normal with ``--full-prior`` (the
                       two-sample joint prior, 8192 loci), (f2) the l2fc
                       scenario ``bench_utils.L2FC_SCENARIO`` (tumor and
                       relapse contaminated by normal, l2fc(relapse, tumor)
                       events: the star-component loop, 8192 loci), (f3) a
                       three-sample contamination cycle (2048 loci); each
                       timed with CUDA events after a warm-up (every output
                       copied to the host), with its peak memory, K1's
                       launches and shapes per call and the grid-axis loop
                       steps per call, and its first 1024 loci re-run with
                       the plain K1 and compared; then ``call variants
                       generic --full-prior --device cuda`` on 20,000
                       synthetic tumor/normal loci (K1 launches per window),
                       its first 2,000 loci re-called with ``--device cpu``
                       and compared; and the host seconds of the
                       --full-prior prior tables (tumor-normal, and the
                       benchmark's de novo trio at 0.01: 101^3 cells).
  (g) preprocess_threads
                       the tumors of phases (d) and (e) again through
                       ``preprocess variants --threads N --device cuda``:
                       N = 2, 4 and 8 (each capped by the cores this process
                       may run on) on phase (d)'s world, N = 4 in
                       homopolymer mode on phase (e)'s; each worker process
                       runs the pair-HMM on the card in its own CUDA context.
                       Per run: wall seconds and loci/s, each worker's
                       seconds from spawn to its entry (interpreter, imports),
                       to its device being ready (CUDA context, kernel
                       library) and to its end, the K2 / K3 / K4 launches and forwards the
                       workers report, and every record compared with the
                       serial file; the workers' forwards must equal the
                       serial run's, K3 (K4) must launch in every worker and
                       nothing in the parent.  Also the core counts, the
                       card's compute mode and the seconds a bare
                       interpreter takes to import torch.
  (h) legacy_and_estimates
                       (h1) ``call variants tumor-normal --device cuda``
                       under ``VLT_LEGACY_CALL=1`` (the legacy per-WorkItem
                       caller, ``PosteriorEngine.run``) on the first
                       LEGACY_LOCI loci of phase (c)'s files: loci/s, K1's
                       launches (two per 64-locus call_batch) and shapes,
                       K1 held to its plain version at its first launches'
                       own inputs (timed, with their bound), the first
                       LEGACY_CPU loci re-called with ``--device cpu`` and
                       compared; (h2) phase (d)'s observation files
                       re-encoded into the reference's v15 .bcf and called
                       on the columnar and on the legacy path (the head of
                       each .bcf re-called on the CPU and compared), then
                       ``filter-calls control-fdr``; (h3) ``estimate
                       contamination --device cuda`` on dedicated synthetic
                       files (the loci that pass the candidate filter are
                       printed; at least 500), its TSV against a ``--device
                       cpu`` run; (h4) ``call cnvs --device cuda`` on phase
                       (d)'s calls (with the depth channel of its
                       observation files) and on phase (c)'s calls, each
                       VCF byte-identical to the ``--device cpu`` run, with
                       the Viterbi's seconds and steps.
  (i) kinds_and_testcases
                       (i1) the all-kinds world (``synth_preprocess_world``
                       with ``kinds``, ``ratchet`` and ``methylation``:
                       MNVs, replacements, ``<*>``, inversions and
                       duplications of 150-2,000 bases, inversions as BND
                       groups, ``<METH>`` candidates with MM / ML tags, long
                       tumor indels and clips that move the alignment-
                       property maxima; KINDS_GENOME bases at 30x) through
                       ``estimate``, ``preprocess variants --device cuda``
                       of both samples and the normal's head again with the
                       other gap model (K2 and K3 both launch); their
                       launches by panel shape, the first KINDS_CHECKED of
                       each whose panel is not 128 x 128 against the plain
                       kernel on their own inputs (K23_TOL above
                       FORWARD_FLOOR), a ``--device cpu`` re-preprocess of
                       the head (``kinds_head``: KINDS_CPU loci of each
                       kind) compared kind by kind, call and FDR; (i2) one
                       testcase per kind captured with ``call variants
                       generic --testcase-*`` on the card and replayed with
                       ``Testcase.run`` on the card and on the CPU (the
                       VCFs compared; K1 and, for the SV and replacement
                       kinds, K3 launch in the card's replays).
  (j) sharded          locus sharding (``parallel/``): (j1)
                       ``dryrun_multichip`` over every card (the sharded
                       engine, the sharded ``call_generic`` byte-identical to
                       the single-device panels route and within 1.1e-4 of the
                       wire route, ``control_fdr_sharded``); (j2) the engine
                       cell's inputs (SHARDED_LOCI loci, depth 64) in two
                       shards on cuda:0 through ``run_sharded``, every output
                       against ``engine.run`` on the card, K1's launches per
                       shard; (j3) SHARDED_RANKS ranks over gloo sharing the
                       card (torchrun's environment, the no-JAX guard), each
                       with its half of j2's batch and its region half of
                       phase (c)'s files through ``call_generic(mesh=...)``
                       and ``control_fdr_sharded``: the rows against j2's
                       single run, the calls against phase (c)'s, the kept
                       sets against phase (c)'s FDR; each rank's seconds from
                       spawn, loci/s, K1 launches and gather seconds; (j4)
                       ``all_gather_rows`` of float64 rows over NCCL in a
                       world of one rank on cuda:0, bit for bit.  NCCL
                       between two cards is not run: one card here.
  (k) wavefront_vs_plain, wavefront_routes
                       (k1) the wavefront kernel (csrc/pairhmm_wavefront.cu)
                       of each flavour (banded, positional, hop-state)
                       against its plain torch version on the card, at the
                       main-path panel WAVEFRONT_MAIN_SHAPE without a band
                       and with the realigner's band (semiglobal edit
                       distance + 4), on the ragged _synth set, the edge
                       sets of (a') and reads over 1023 bases (K23_TOL
                       above FORWARD_FLOOR, -1e30 alike); the main-path
                       sets timed with CUDA events beside their bound;
                       (k2) ``preprocess variants --pairhmm-mode
                       homopolymer --region`` under VLT_HOP_STATES=1 on
                       the head of phase (e)'s candidates (HOP_REGION_LOCI),
                       on the card and on the CPU, compared, loci/s; (k3)
                       the same under VLT_PALLAS_PAIRHMM=0 on the head of
                       phase (d)'s (BANDED_REGION_LOCI; the banded
                       wavefront), and in homopolymer mode on (k2)'s region
                       (its positional flavour); (k4) VLT_NATIVE_PAIRHMM=1
                       on both regions: no pair-HMM kernel launches, the
                       files agree with (k3)'s.

The contraction's launches are counted in phases (c), (f) (by mode and in
its CLI run) and (j) (the ranks' own counts included); each of them but
(f)'s contamination cycle, which has no tree node, must launch it.

The engine's event and MAP / AFD passes (``PosteriorEngine._assemble``
calls) are counted in phases (b), (c), (f) and (j) (the ranks' own counts
included), the assemble head and tail kernels' counters zeroed where each
of these blocks starts; each pass must launch the head and the tail once.
The kernels line gives the two kernels those counts and (a''''')'s checked
cases (not its timing loops), by phase.

The line before the last lists the kernels ({"kernels": [...]}): K1 with the
launches counted in phases (c), (f), (h), (i) and (j) (the ranks' own counts
included), the contraction with those of its phases and its time,
plain time and bound at the B = 8 shape (and a window's, ``window``), the
wavefront kernel by flavour with those of phase (k),
its time at WAVEFRONT_MAIN_SHAPE (and with the band, ``banded``), K2-K4 with
those counted in
phase (d)'s preprocess steps, phase (e)'s, phase (g)'s workers and phase
(i)'s preprocess and replays (each also by phase, ``launches_by_phase``; K2
and K3 take the larger error of phases (a') and (i)); each with its time, its
plain version's, and its bound (operations over the float32 peak or bytes
over the memory rate, whichever is larger, on that kernel's timed inputs;
K2-K4 at 16384 x 256 x 150, and each also at its main-path shape,
``main_path_shape``, with the tile); no single PyTorch call computes any of them
(library_ms null); the last
line is
{"ok": true, "device": {...}}.  Any failure exits non-zero, and without a
CUDA device the script exits non-zero before printing anything.  Scratch
files go to build/chip_smoke/ inside the checkout.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K1_SOURCE = "varlociraptor_tpu_torch/csrc/ll_classes.cu"
K1_REPLACES = "varlociraptor_tpu/ops/pallas_kernels.py:42"
K1_TOL = 5e-5  # x max(1, |x|); f32 logs summed in another order
K23_SOURCE = "varlociraptor_tpu_torch/csrc/pairhmm_column.cu"
K2_REPLACES = "varlociraptor_tpu/ops/pallas_pairhmm.py:60"
K3_REPLACES = "varlociraptor_tpu/ops/pallas_pairhmm.py:290"
K4_REPLACES = "varlociraptor_tpu/ops/pallas_pairhmm.py:296"
# x max(1, |x|): f32 column sums in another order, the D scan in another
# association; -1e30 (impossible) must match exactly
K23_TOL = 1e-4
LC_SOURCE = "varlociraptor_tpu_torch/csrc/lse_contract.cu"
LC_REPLACES = "varlociraptor_tpu/ops/posterior.py:645"
# x max(1, |x|): f32 exps and logs, the sum over v in another order than the
# einsum's; -inf must fall in the same places
LC_TOL = 2e-5
LFS_SOURCE = "varlociraptor_tpu_torch/csrc/lfc_star.cu"
LFS_REPLACES = "varlociraptor_tpu/ops/posterior.py:1228"
# the star l2fc integral against its plain version: the larger of the two
# (f32 ex2.approx, the sum over (g, ga, gb) in another order than the
# loop's), -inf in the same places, never NaN
LFC_TOL_REL = 2e-6
LFC_TOL_ABS = 1e-4
# phase (a'''')'s timed cases: the relapse_l2fc cell's branch and (f2)'s
LFS_TIMED = ("cell", "f2")
AS_SOURCE = "varlociraptor_tpu_torch/csrc/assemble.cu"
AS_REPLACES = "varlociraptor_tpu/ops/posterior.py:1531-1705 (XLA; no Pallas kernel)"
# phase (a''''')'s timed cases: the two cells' windows and a 1001-point grid
AS_TIMED = ("tumor_normal", "relapse_l2fc", "g1001")
# phase (a''')'s timed cases: the call's three kinds of contraction (a
# window makes one "unit", two "map" and one "afd_swapped") and a grid larger
# than a block's shared memory
LC_TIMED = ("unit", "map", "afd_swapped", "large")
LC_WINDOW = {"unit": 1, "map": 2, "afd_swapped": 1}
# phase (a')'s timed pair-HMM shapes (items x allele x read): the bench
# shapes, and the K2 and K3 launch shapes that carry the most cells on phase
# (d)'s main path (their median items per launch, the panel width, 100-base
# reads; from phase (d)'s k2_shapes and k3_shapes records); phase (a'')
# times K4 at the same and at K4's main-path shape (phase (e)'s k4_shapes
# record)
BENCH_SET = "b16384_x256_y150"
K2_MAIN_SHAPE = (4394, 128, 100)
K2_MAIN_SET = "b{}_x{}_y{}_k2main".format(*K2_MAIN_SHAPE)
K3_MAIN_SHAPE = (4408, 128, 100)
MAIN_SET = "b{}_x{}_y{}_main".format(*K3_MAIN_SHAPE)
K4_MAIN_SHAPE = (4326, 128, 100)
K4_MAIN_SET = "b{}_x{}_y{}_k4main".format(*K4_MAIN_SHAPE)
TIMED_SETS = ("b4096_x160_y100", BENCH_SET, K2_MAIN_SET, MAIN_SET, K4_MAIN_SET)
# phases (d) and (e) re-time their first K3 / K4 launches warm and save
# their inputs
RERUN = 8
K2_LAUNCHES_FILE = "k2_main_launches.pt"
K3_LAUNCHES_FILE = "k3_main_launches.pt"
K4_LAUNCHES_FILE = "k4_main_launches.pt"
# log gap params (t_mi, t_md, t_ii, t_dd): the default zero-extension model
# and ONT-like finite extensions (tests/test_pallas_pairhmm.py)
GAP_ZERO = (-12.785891140783116, -12.186270018233994, -1e30, -1e30)
GAP_ONT = (-5.278515, -5.472671, -1.049822, -0.867501)
# homopolymer hop rates of phase (a''): ln 0.05 for every base, open == extend
# as the estimator gives them
HOP_LN = -2.995732273553991
# top-level packages the port must never import, and the directory whose
# sitecustomize.py blocks them in the processes this script starts
REFUSED = ("jax", "jaxlib", "varlociraptor_tpu")
NO_JAX_GUARD = "scripts/torch_no_jax"
# NVIDIA H100 SXM peaks (data sheet, 700 W): float32 outside the tensor
# cores, and HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations, an FMA counted as 2 as the peak counts it.  K1 per
# (row, class, read): w = clip(p * (nu - kappa) + kappa, 0, 1) (one FMA, the
# clip a saturate), t = w * (a - r) + (r + m) (one FMA), the log and the read
# sum: 6; a - r and r + m once per (row, read), nu - kappa once per class.
K1_OPS_PER_CELL = 6
# K2 / K3 / K4 per (allele row, read base) of their column recurrences
# (ops/pairhmm_column.py plain versions)
OPS_PER_CELL = {"exact": 7, "general": 16, "positional": 19}


_START = time.perf_counter()


class PhaseError(RuntimeError):
    pass


class _RefuseJax:
    """Import hook that refuses ``jax`` / ``jaxlib`` and the JAX package
    ``varlociraptor_tpu``, and keeps the stack of every attempt: the port must
    run without JAX and without the JAX package even where they are
    installed.  A library's guarded optional import just sees ImportError."""

    def __init__(self):
        self.attempts = []

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            import traceback

            self.attempts.append((name, "".join(traceback.format_stack(limit=25))))
            raise ModuleNotFoundError(f"chip_smoke refuses to import {name}", name=name)
        return None


def roofline(ops, nbytes):
    """The least time the card could take: operations over the float32
    peak or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_roofline(args):
    """K1's bound on its inputs: every (row, class, read) cell, each input
    read once and the [N, U] output written once."""
    N, D = args[0].shape
    U = args[4].shape[0]
    return roofline(K1_OPS_PER_CELL * N * U * D + 2 * N * D + U,
                    4 * (4 * N * D + 2 * U + N * U))


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters, warmup=1, ahead=False):
    """Mean milliseconds per call from CUDA events, after a warm-up.  With
    ``ahead`` the card first spins ~0.5 ms per call, so that the host has
    queued every call before the first one runs: a kernel shorter than its
    wrapper's host work (the pair-HMM's ~0.07 ms at the main-path shapes)
    is then timed back to back and not at the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(1_000_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_k1():
    """Route the engine's K1 calls to the plain torch version (for the
    comparison runs only)."""
    from varlociraptor_tpu_torch.ops import ll_classes as k1

    kernel = k1.ll_classes
    k1.ll_classes = k1.ll_classes_reference
    try:
        yield
    finally:
        k1.ll_classes = kernel


@contextlib.contextmanager
def assemble_passes(what, card=True):
    """The engine's event and MAP / AFD passes of a main-path block: yields
    a dict whose ``passes`` (calls of ``PosteriorEngine._assemble``) is
    filled on exit.  The head and tail kernels' counters start at 0 here,
    as the main path's K1 and contraction counters do; PhaseError unless
    the block made a pass and each pass launched the head and the tail
    once (none with ``card`` False: a rehearsal on the CPU)."""
    from varlociraptor_tpu_torch.ops import assemble as asm
    from varlociraptor_tpu_torch.ops.posterior import PosteriorEngine

    res = {"passes": 0}
    inner = PosteriorEngine._assemble

    def counted(self, *args, **kw):
        res["passes"] += 1
        return inner(self, *args, **kw)

    asm.assemble_head.launches = asm.assemble_tail.launches = 0  # main path
    PosteriorEngine._assemble = counted
    try:
        yield res
    finally:
        PosteriorEngine._assemble = inner
    head, tail = asm.assemble_head.launches, asm.assemble_tail.launches
    want = res["passes"] if card else 0
    if not res["passes"] or head != want or tail != want:
        raise PhaseError(f"{what}: {res['passes']} assemble passes launched the head "
                         f"{head} and the tail {tail} times, not once each a pass")


def edge_rows(seed, dev, L=16, B=3, D=24, U=37):
    """The edge shapes of tests/test_pallas_kernel.py (N = 48 rows, not a
    multiple of the row tile; U = 37; D = 24), folded K1 inputs."""
    import numpy as np
    import torch

    from varlociraptor_tpu_torch.evidence.observation import F, FEATURES
    from varlociraptor_tpu_torch.ops.likelihood import _read_terms

    rng = np.random.default_rng(seed)
    feats = np.full((L, D, len(FEATURES)), -1.0, np.float32)
    for k in ("prob_alt", "prob_ref", "prob_mapping", "prob_mismapping",
              "prob_missed_allele", "prob_sample_alt"):
        feats[..., F[k]] = np.log(rng.uniform(0.01, 1.0, (L, D)))
    mask = rng.uniform(size=(L, D)) < 0.8
    bias = [np.log(rng.uniform(0.1, 1, (L, B, D))).astype(np.float32)
            for _ in range(3)]
    nu = rng.uniform(0, 1, U).astype(np.float32)
    nu[3] = 1.0
    kap = np.zeros(U, np.float32)
    kap[3] = 1.0
    t = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    a, r, m, c, psa = _read_terms(t(feats), *map(t, bias))
    mk = t(mask)[:, None, :]
    fold = lambda x, v: torch.where(mk, x, v).reshape(L * B, D).contiguous()  # noqa: E731
    return (fold(a, 1.0), fold(r, 1.0), fold(m, 0.0),
            psa.expand(L, B, D).reshape(L * B, D).contiguous(), t(nu), t(kap))


def phase_kernel_vs_plain(engine, bench_loci=32768, window_loci=1024, timer=cuda_ms):
    import numpy as np
    import torch

    from varlociraptor_tpu_torch.bench_utils import K1_EDGE_CASES, k1_edge_rows
    from varlociraptor_tpu_torch.bench_utils import k1_engine_rows as k1_rows
    from varlociraptor_tpu_torch.ops.ll_classes import ll_classes, ll_classes_reference

    cases = [
        ("pair_d64", k1_rows(engine, 1024, 64, 0, "pair")),
        ("pair_d128", k1_rows(engine, 1024, 128, 1, "pair")),
        ("grid_d64", k1_rows(engine, 1024, 64, 2, "grid")),
        ("edge_seed0", edge_rows(0, engine.device)),
        ("edge_seed7", edge_rows(7, engine.device)),
    ] + [(name, tuple(torch.as_tensor(x, device=engine.device) for x in k1_edge_rows(name)))
         for name in K1_EDGE_CASES]

    def check(name, args):
        """Kernel against the plain version: the same finiteness, K1_TOL."""
        g = ll_classes(*args).cpu().numpy()
        r = ll_classes_reference(*args).cpu().numpy()
        fin = np.isfinite(r)
        if not np.array_equal(np.isfinite(g), fin):
            raise PhaseError(f"K1 {name}: finiteness differs from the plain version")
        abs_err = float(np.max(np.abs(g[fin] - r[fin]))) if fin.any() else 0.0
        rel = float(np.max(np.abs(g[fin] - r[fin]) / np.maximum(1, np.abs(r[fin])))) if fin.any() else 0.0
        if not rel <= K1_TOL:
            raise PhaseError(f"K1 {name}: rel err {rel} > {K1_TOL}")
        N, D = args[0].shape
        return {"case": name, "N": N, "U": int(args[4].shape[0]), "D": D,
                "max_abs_err": abs_err, "max_rel_err": rel}

    results = []
    for name, args in cases:
        results.append({
            **check(name, args),
            "ms": timer(lambda: ll_classes(*args), 20),
            "plain_ms": timer(lambda: ll_classes_reference(*args), 5),
        })
    # the engine's own shapes: the bench size (32768 loci x 4 combos) and
    # the call CLI's window (1024 loci x 4 combos)
    for name, n_loci in (("pair_window", window_loci), ("pair_bench", bench_loci)):
        big = k1_rows(engine, n_loci, 64, 0, "pair")
        bench = {
            **check(name, big),
            "ms": timer(lambda: ll_classes(*big), 20 if name == "pair_window" else 5),
            "plain_ms": timer(lambda: ll_classes_reference(*big), 2),
            **k1_roofline(big),
        }
        results.append(bench)
    worst = max(case["max_abs_err"] for case in results)
    return {"phase": "kernel_vs_plain", "tol_rel": K1_TOL, "cases": results,
            "max_abs_err": worst}, bench


def lc_roofline(F, S, table):
    """The contraction's bound on its inputs: F, the distinct rows of S (an
    S expanded over B is read once) and the output once at the memory
    rate; operations an FMA (2) per (l, b, branch, v of its class, u) and
    an exp per (l, b, class, v of the class, u)."""
    L, B, Gv, Gu = F.shape
    NB = S.shape[2]
    sizes = table.masks.sum(dim=1).tolist()
    cls = table.branch_class.tolist()
    fma = sum(sizes[k] for k in cls if k >= 0)
    exps = sum(sizes[k] for k in set(cls) if k >= 0)
    s_rows = L * (B if S.stride(1) else 1) * NB
    return roofline(L * B * Gu * (2 * fma + exps),
                    4 * (F.numel() + s_rows * Gv + L * B * NB * Gu))


def phase_contraction_vs_plain(timer=cuda_ms):
    """(a'''): the engine's grid contraction (csrc/lse_contract.cu) against
    its plain version on the card, on every case of
    ``bench_utils.lse_contract_args``: -inf in the same places, the rest
    within LC_TOL x max(1, |x|); the LC_TIMED cases timed with CUDA events
    (the card held ahead of the host) beside their bound, and a window's
    four at the call's shapes summed."""
    import numpy as np

    from varlociraptor_tpu_torch.bench_utils import LSE_CONTRACT_CASES, lse_contract_args
    from varlociraptor_tpu_torch.ops import lse_contract as lc

    cases = {}
    for name in LSE_CONTRACT_CASES:
        F, S, table = lse_contract_args(name, "cuda", seed=5)
        n0 = lc.lse_contract.launches
        g = lc.lse_contract(F, S, table).cpu().numpy()
        if lc.lse_contract.launches != n0 + 1:
            raise PhaseError(f"contraction {name}: the kernel did not launch once")
        r = lc.lse_contract_reference(F, S, table.per).cpu().numpy()
        fin = np.isfinite(r)
        if not (np.array_equal(np.isfinite(g), fin) and np.array_equal(g[~fin], r[~fin])):
            raise PhaseError(f"contraction {name}: -inf differs from the plain version")
        err = np.abs(g[fin] - r[fin])
        rel = float(np.max(err / np.maximum(1.0, np.abs(r[fin])))) if fin.any() else 0.0
        if not rel <= LC_TOL:
            raise PhaseError(f"contraction {name}: rel err {rel} > {LC_TOL}")
        case = {"case": name, "F": list(F.shape), "F_strides": list(F.stride()),
                "S": list(S.shape), "S_strides": list(S.stride()),
                "classes": table.masks.shape[0], "groups": table.groups.shape[0],
                "not_finite": int((~fin).sum()),
                "max_abs_err": float(err.max()) if fin.any() else 0.0, "max_rel_err": rel}
        if name in LC_TIMED:
            case["ms"] = timer(lambda: lc.lse_contract(F, S, table), 100, ahead=True)
            case["plain_ms"] = timer(lambda: lc.lse_contract_reference(F, S, table.per), 5)
            case.update(lc_roofline(F, S, table))
        cases[name] = case
    window = {k: sum(cases[c][k] * n for c, n in LC_WINDOW.items())
              for k in ("ms", "plain_ms", "bound_ms")}
    return {"phase": "contraction_vs_plain", "tol_rel": LC_TOL, "cases": list(cases.values()),
            "window": {**window, "launches": sum(LC_WINDOW.values())},
            "max_abs_err": max(c["max_abs_err"] for c in cases.values())}, cases["unit"]


def phase_lfc_star_vs_plain(timer=cuda_ms):
    """(a''''): the engine's star l2fc integral (csrc/lfc_star.cu) against
    its plain version on the card, on every case of
    ``bench_utils.lfc_star_args``: -inf in the same places, never NaN, the
    rest within LFC_TOL_REL x |x| or LFC_TOL_ABS, whichever is larger; the
    LFS_TIMED cases timed with CUDA events (the card held ahead of the host)
    beside their bound."""
    import numpy as np

    from portbench.lib.roofline_lfc import lfc_roofline
    from varlociraptor_tpu_torch.bench_utils import LFC_STAR_CASES, lfc_star_args
    from varlociraptor_tpu_torch.ops import lfc_star as ls

    cases = []
    for name in LFC_STAR_CASES:
        args = lfc_star_args(name, "cuda", seed=5)
        pa, _, pb, _, lm, rp = args
        n0 = ls.lfc_star.launches
        g = ls.lfc_star(*args).cpu().numpy()
        if ls.lfc_star.launches != n0 + 1:
            raise PhaseError(f"lfc_star {name}: the kernel did not launch once")
        r = ls.lfc_star_reference(*args).cpu().numpy()
        fin = np.isfinite(r)
        if np.isnan(g).any() or not (np.array_equal(np.isfinite(g), fin)
                                     and np.array_equal(g[~fin], r[~fin])):
            raise PhaseError(f"lfc_star {name}: -inf or NaN differs from the plain version")
        err = np.abs(g[fin] - r[fin])
        lim = np.maximum(LFC_TOL_REL * np.abs(r[fin]), LFC_TOL_ABS)
        worst = float(np.max(err / lim)) if fin.any() else 0.0
        if not worst <= 1.0:
            raise PhaseError(f"lfc_star {name}: {worst} x the tolerance")
        case = {"case": name, "shape": [*pa.shape[:3], pb.shape[2], rp.shape[2]],
                "not_finite": int((~fin).sum()),
                "max_abs_err": float(err.max()) if fin.any() else 0.0,
                "max_err_over_tol": worst}
        if name in LFS_TIMED:
            L, B, Gp = rp.shape
            case["ms"] = timer(lambda: ls.lfc_star(*args), 20, ahead=True)
            case["plain_ms"] = timer(lambda: ls.lfc_star_reference(*args), 2)
            # the engine's _lfc_count of the branch: the joint grid's cells,
            # the inputs read once and the two [L, B] outputs written once
            cells = L * B * lm.numel() * Gp
            bound = lfc_roofline(
                cells, 4 * (pa.numel() + pb.numel() + rp.numel() + lm.numel() + 2 * L * B))
            case.update(cells=cells, bound_ms=bound["bound_s"] * 1e3, bound_by=bound["bound_by"],
                        roofline_share=bound["bound_s"] * 1e3 / case["ms"])
        cases.append(case)
    timed = {c["case"]: c for c in cases if "ms" in c}
    return {"phase": "lfc_star_vs_plain", "tol_rel": LFC_TOL_REL, "tol_abs": LFC_TOL_ABS,
            "cases": cases, "max_abs_err": max(c["max_abs_err"] for c in cases)}, timed["cell"]


def assemble_bytes(tables, head, tail):
    """The bytes bound of the pass's head and tail: every input read once
    (the tables included) and every output written once."""
    bv, gates, n_art, _, w = head
    d_own, U0, _, marginal = tail
    L, B, NB = bv.shape
    E, S = tables.n_events, len(w)
    table_bytes = sum(x.numel() * x.element_size() for x in (
        tables.ev_ptr, tables.ev_br, tables.ev_art, tables.art_br, tables.branch_event))
    w_bytes = sum(x.numel() * 4 for x in w)
    head_bytes = (bv.numel() * 4 + gates.numel() + (0 if n_art is None else L * 4) + table_bytes
                  + 2 * w_bytes + L * (2 * E * 4 + 4 + B * 4 + 8))
    widths = [k + b.shape[0] for k, b in zip(tables.top_k, tables.backbone)]
    tail_bytes = (sum(x.numel() * 4 for x in d_own) + sum(u.numel() * 4 for u in U0) + L * 4
                  + sum(v.numel() * 4 for v in tables.values)
                  + sum(b.numel() * 8 for b in tables.backbone)
                  + L * (S * 4 + 2 * sum(widths) + 2 * sum(tables.top_k)))
    return head_bytes, tail_bytes


def phase_assemble_vs_plain(timer=cuda_ms):
    """(a'''''): the engine's event and MAP / AFD pass, its head and tail
    kernels (csrc/assemble.cu), against their plain versions on the card,
    on every case of ``bench_utils.assemble_args``
    (``bench_utils.assemble_mismatches`` at LC_TOL); the AS_TIMED cases
    timed with CUDA events (the card held ahead of the host) beside their
    bytes bound and the plain versions."""
    from varlociraptor_tpu_torch.bench_utils import (
        ASSEMBLE_CASES, assemble_args, assemble_mismatches,
    )
    from varlociraptor_tpu_torch.ops import assemble as asm

    cases = []
    for name in ASSEMBLE_CASES:
        tables, head, tail = assemble_args(name, "cuda", seed=5)
        n0 = asm.assemble_head.launches + asm.assemble_tail.launches
        got_head = asm.assemble_head(*head, tables)
        got_tail = asm.assemble_tail(*tail, tables)
        if asm.assemble_head.launches + asm.assemble_tail.launches != n0 + 2:
            raise PhaseError(f"assemble {name}: the kernels did not launch once each")
        ref_head = asm.assemble_head_reference(*head, tables)
        ref_tail = asm.assemble_tail_reference(*tail, tables)
        problems, worst = assemble_mismatches(tables, tail, got_head, ref_head, got_tail,
                                              ref_tail, LC_TOL)
        if problems:
            raise PhaseError(f"assemble {name}: {problems}")
        bv = head[0]
        case = {"case": name, "L": bv.shape[0], "B": bv.shape[1], "NB": bv.shape[2],
                "E": tables.n_events, "G": [v.shape[0] for v in tables.values],
                "components": len(tail[1]), "worst": worst,
                "max_abs_err": max(v for k, v in worst.items()
                                   if "near" not in k and "off_by" not in k)}
        if name in AS_TIMED:
            head_bytes, tail_bytes = assemble_bytes(tables, head, tail)
            case["head"] = {
                "ms": timer(lambda: asm.assemble_head(*head, tables), 50, ahead=True),
                "plain_ms": timer(lambda: asm.assemble_head_reference(*head, tables), 5),
                "bytes": head_bytes, "bound_ms": head_bytes / PEAK_BYTES * 1e3}
            case["tail"] = {
                "ms": timer(lambda: asm.assemble_tail(*tail, tables), 50, ahead=True),
                "plain_ms": timer(lambda: asm.assemble_tail_reference(*tail, tables), 5),
                "bytes": tail_bytes, "bound_ms": tail_bytes / PEAK_BYTES * 1e3}
            for part in ("head", "tail"):
                case[part]["roofline_share"] = case[part]["bound_ms"] / case[part]["ms"]
        cases.append(case)
    return {"phase": "assemble_vs_plain", "tol_rel": LC_TOL, "cases": cases,
            "max_abs_err": max(c["max_abs_err"] for c in cases)}, cases[0]


def phase_engine(engine, L=32768, n_plain=1024):
    import numpy as np
    import torch

    from varlociraptor_tpu_torch.bench_utils import engine_inputs
    from varlociraptor_tpu_torch.compare import compare_outputs
    from varlociraptor_tpu_torch.ops import ll_classes as k1
    from varlociraptor_tpu_torch.ops import lse_contract as lc

    inputs = engine_inputs(engine, n_loci=L, depth=64, seed=0)
    engine.run(*inputs)  # warm-up: first launches, allocator growth
    n0, c0 = k1.ll_classes.launches, lc.lse_contract.launches
    times = []
    with assemble_passes("engine", engine.device.type == "cuda") as passes:
        for _ in range(3):
            t0 = time.perf_counter()
            out = engine.run(*inputs)  # every output lands on the host
            times.append(time.perf_counter() - t0)
    launches = k1.ll_classes.launches - n0
    contractions = lc.lse_contract.launches - c0
    if launches != 2 * len(times):
        raise PhaseError(f"engine: K1 launched {launches} times in {len(times)} calls")
    if passes["passes"] != len(times):
        raise PhaseError(f"engine: {passes['passes']} assemble passes in {len(times)} calls")
    if contractions != 4 * len(times):
        raise PhaseError(f"engine: the contraction launched {contractions} times in "
                         f"{len(times)} calls")
    if out["posteriors"].shape != (L, engine.n_events) or out["af"].shape != (L, engine.n_samples):
        raise PhaseError("engine: output shapes")
    if not (np.isfinite(out["marginal"]).all() and np.isfinite(out["af"]).all()):
        raise PhaseError("engine: non-finite marginal or af")
    sub = [np.asarray(x)[:n_plain] for x in inputs]
    with plain_k1():
        plain = engine.run(*sub)
    head = {k: v[:n_plain] for k, v in out.items()}
    problems, info = compare_outputs(plain, head)
    if problems:
        raise PhaseError("engine vs plain K1: " + "; ".join(problems[:5]))
    best = min(times)
    return {
        "phase": "engine", "n_loci": L, "depth": 64, "resolution": 0.01,
        "U": len(engine.pair_class[engine.pairs[0][0]][0]),
        "seconds": times, "loci_per_s": L / best,
        "k1_launches_per_call": launches // len(times),
        "contractions_per_call": contractions // len(times),
        "assemble_passes_per_call": passes["passes"] // len(times),
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                        if engine.device.type == "cuda" else None),
        "vs_plain_head": {"n_loci": n_plain, "max_rel": info["max_rel"], "af_max": info["af_max"],
                          "topk_swaps": len(info["topk_swaps"])},
    }


def subset_files(src_paths, dst_dir, n):
    """First n loci of each observation file, rewritten with the port's
    ObservationReader / ObservationWriter."""
    from varlociraptor_tpu_torch.calling.observations import (
        ObservationReader,
        ObservationWriter,
    )

    out = []
    for path in src_paths:
        r = ObservationReader(path)
        variants, counts, cols, dp = r.read_window(n)
        r.close()
        dst = Path(dst_dir) / Path(path).name
        with ObservationWriter(str(dst), r.sample_name) as w:
            w.write_window(variants, counts, cols, dp)
        out.append(str(dst))
    return out


def phase_cli(work, n_loci=100_000, n_cpu=2000, device="cuda"):
    import numpy as np

    from varlociraptor_tpu_torch import cli
    from varlociraptor_tpu_torch.bench_utils import synth_observation_files
    from varlociraptor_tpu_torch.compare import compare_vcf_text, vcf_record_keys
    from varlociraptor_tpu_torch.ops import ll_classes as k1
    from varlociraptor_tpu_torch.ops import lse_contract as lc

    t0 = time.perf_counter()
    tumor, normal, truth = synth_observation_files(work / "obs", n_loci=n_loci, seed=0)
    synth_s = time.perf_counter() - t0
    calls = work / "calls.vcf"
    k1.ll_classes.launches = 0  # main path starts here
    lc.lse_contract.launches = 0
    with assemble_passes("cli", device == "cuda") as passes:
        t0 = time.perf_counter()
        rc = cli.run(["call", "variants", "tumor-normal", "--tumor", tumor,
                      "--normal", normal, "--purity", "0.75", "--device", device,
                      "--output", str(calls)])
        call_s = time.perf_counter() - t0
    launches, contractions = k1.ll_classes.launches, lc.lse_contract.launches
    filtered = work / "somatic.fdr.vcf"
    t0 = time.perf_counter()
    rc |= cli.run(["filter-calls", "control-fdr", str(calls), "--events",
                   "somatic_tumor", "--fdr", "0.05", "--output", str(filtered)])
    fdr_s = time.perf_counter() - t0
    if rc != 0:
        raise PhaseError(f"cli returned {rc}")
    calls_text = calls.read_text()
    n_called = len(vcf_record_keys(calls_text))
    kept_pos = np.array(
        [int(k[1]) - 1 for k in vcf_record_keys(filtered.read_text())], dtype=np.int64
    )
    recall = float(np.isin(truth["somatic"], kept_pos).mean())
    if n_called != n_loci:
        raise PhaseError(f"cli: {n_called} records called, expected {n_loci}")
    if len(kept_pos) == 0 or launches == 0 or contractions == 0:
        raise PhaseError(f"cli: kept {len(kept_pos)}, K1 launches {launches}, "
                         f"contractions {contractions}")

    # CPU re-call of the first n_cpu loci
    sub_dir = work / "obs2k"
    sub_dir.mkdir(parents=True, exist_ok=True)
    t2k, n2k = subset_files([tumor, normal], sub_dir, n_cpu)
    calls_cpu = work / "calls_cpu.vcf"
    t0 = time.perf_counter()
    rc = cli.run(["call", "variants", "tumor-normal", "--tumor", t2k, "--normal",
                  n2k, "--purity", "0.75", "--device", "cpu", "--output",
                  str(calls_cpu)])
    cpu_s = time.perf_counter() - t0
    problems, swapped = compare_vcf_text(calls_cpu.read_text(), vcf_head(calls_text, n_cpu))
    if rc != 0 or problems:
        raise PhaseError("cli cuda vs cpu VCF: " + "; ".join(problems[:3]))
    return {
        "phase": "cli", "n_loci": n_loci, "records": n_called,
        "somatic_kept": int(len(kept_pos)),
        "planted_somatic": int(len(truth["somatic"])),
        "planted_somatic_recall": recall,
        "synth_s": synth_s, "call_s": call_s, "call_loci_per_s": n_loci / call_s,
        "fdr_s": fdr_s, "k1_launches": launches, "contractions": contractions,
        "contractions_per_window": contractions / -(-n_loci // 1024),
        "assemble_passes": passes["passes"],
        "cpu_2k_call_s": cpu_s, "cpu_vs_cuda_topk_swapped_lines": swapped,
    }, launches


def pairhmm_sets():
    """(name, alleles, reads, quals) of phase (a')."""
    from varlociraptor_tpu_torch.bench_utils import (
        pairhmm_edge_items,
        pairhmm_items,
        pairhmm_shape_items,
        pairhmm_tile_items,
    )

    sets = [("b4096_x160_y100", *pairhmm_shape_items(4096, 160, 100, seed=1)),
            (BENCH_SET, *pairhmm_shape_items(16384, 256, 150, seed=2)),
            (K2_MAIN_SET, *pairhmm_shape_items(*K2_MAIN_SHAPE, seed=6)),
            (MAIN_SET, *pairhmm_shape_items(*K3_MAIN_SHAPE, seed=4)),
            ("synth_ragged", *pairhmm_items(21, 3))]
    sets += [(name, *items) for name, items in pairhmm_edge_items().items()]
    sets += [(name, *items) for name, items in pairhmm_tile_items().items()]
    return sets


def pairhmm_case(kind, name, fn, ref_fn, dev, timer):
    """One pair-HMM kernel against its plain version on the same device
    tensors (allele, read, qual, alen, rlen, ...): the same finiteness and
    -1e30 items, the rest within K23_TOL x max(1, |x|); on the sets of
    TIMED_SETS both are timed."""
    import numpy as np
    import torch

    g = fn(*dev).cpu().numpy()
    torch.cuda.synchronize()
    r = ref_fn(*dev).cpu().numpy()
    if not np.array_equal(np.isfinite(g), np.isfinite(r)):
        raise PhaseError(f"{kind} {name}: finiteness differs from the plain version")
    if not np.array_equal(g <= -1e30, r <= -1e30):
        raise PhaseError(f"{kind} {name}: -1e30 results differ from the plain version")
    live = r > -1e30
    err = np.abs(g[live] - r[live]) if live.any() else np.zeros(1)
    rel = float(np.max(err / np.maximum(1.0, np.abs(r[live])))) if live.any() else 0.0
    if not rel <= K23_TOL:
        raise PhaseError(f"{kind} {name}: rel err {rel} > {K23_TOL}")
    n, Xp = dev[0].shape
    case = {"kernel": kind, "case": name, "B": n, "Xp": Xp, "Yp": dev[1].shape[1],
            "impossible": int((~live).sum()), "max_abs_err": float(err.max()),
            "max_rel_err": rel}
    if name in TIMED_SETS:
        case["ms"] = timer(lambda: fn(*dev), 10, ahead=True)
        case["plain_ms"] = timer(lambda: ref_fn(*dev), 2)
        # the cells these items need (allele length x read length), every
        # input read once and the [B] output written once
        cells = (dev[3].double() * dev[4].double()).sum().item()
        case["gcells_per_s"] = cells / case["ms"] / 1e6
        case.update(roofline(OPS_PER_CELL[kind] * cells,
                             sum(t.numel() * t.element_size() for t in dev) + 4 * n))
    return case


def phase_pairhmm_vs_plain(timer=cuda_ms):
    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    out = {"phase": "pairhmm_vs_plain", "tol_rel": K23_TOL, "cases": []}
    worst = {"exact": 0.0, "general": 0.0}
    main_sets = {"exact": K2_MAIN_SET, "general": MAIN_SET}
    tile_of = {"exact": phc.exact_tile, "general": phc.general_tile}
    bench, main = {}, {}
    for name, alleles, reads, quals in pairhmm_sets():
        for kind, gap in (("exact", GAP_ZERO), ("general", GAP_ONT)):
            args, _, _, _ = phc.pack_exact_batch(alleles, reads, quals, gap)
            if kind == "general":
                args = args[:5] + (phc.general_coef(gap),)
            dev = phc.to_device(args, "cuda")
            case = pairhmm_case(kind, name, getattr(phc, f"{kind}_forward"),
                                getattr(phc, f"{kind}_forward_reference"), dev, timer)
            case["tile"] = list(tile_of[kind](case["Xp"]))
            worst[kind] = max(worst[kind], case["max_abs_err"])
            if name == BENCH_SET:
                bench[kind] = case
            elif name == main_sets[kind]:
                main[kind] = case
            out["cases"].append(case)
    out["max_abs_err"] = worst
    return out, bench, main


def positional_sets():
    """(name, alleles, reads, quals) of phase (a''): those of (a') and K4's
    main-path shape."""
    from varlociraptor_tpu_torch.bench_utils import pairhmm_shape_items

    return pairhmm_sets() + [(K4_MAIN_SET, *pairhmm_shape_items(*K4_MAIN_SHAPE, seed=5))]


def phase_positional_vs_plain(timer=cuda_ms):
    """(a''): K4 on the sets of (a'), the gap panels built on the card."""
    from varlociraptor_tpu_torch.estimation.alignment_properties import HopParams
    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    hop = HopParams(*([[HOP_LN] * 4] * 4))
    out = {"phase": "positional_vs_plain", "tol_rel": K23_TOL, "hop_ln": HOP_LN,
           "gap": GAP_ONT, "cases": []}
    bench, main, worst = None, None, 0.0
    for name, alleles, reads, quals in positional_sets():
        dev = phc.positional_args(alleles, reads, quals, GAP_ONT, hop, "cuda")
        case = pairhmm_case("positional", name, phc.positional_forward,
                            phc.positional_forward_reference, dev, timer)
        case["tile"] = list(phc.positional_tile(case["Xp"]))
        worst = max(worst, case["max_abs_err"])
        if name == BENCH_SET:
            bench = case
        elif name == K4_MAIN_SET:
            main = case
        out["cases"].append(case)
    out["max_abs_err"] = worst
    return out, bench, main


def shape_record(launches):
    """K2's, K3's or K4's launches by panel shape (Xp x Yp): launches, items, the cells
    the items need (sum of alen x rlen), the allele rows the kernel computes
    (B x the tile's rows), kernel and around-launch ms; the median items per
    launch; and the (B, Xp, Yp) of the shape that carries the most cells
    (B its median)."""
    import statistics

    by = {}
    for rec in launches:
        B, Xp = rec["allele"].shape
        s = by.setdefault(f"{Xp}x{rec['read'].shape[1]}", {
            "Xp": Xp, "Yp": rec["read"].shape[1], "tile": list(rec["tile"]), "launches": 0,
            "items": 0, "B": [], "cells": 0, "rows_computed": 0, "kernel_ms": 0.0,
            "around_ms": 0.0})
        s["launches"] += 1
        s["items"] += B
        s["B"].append(B)
        s["cells"] += int((rec["alen"].double() * rec["rlen"].double()).sum().item())
        s["alen_sum"] = s.get("alen_sum", 0) + int(rec["alen"].sum().item())
        s["rlen_sum"] = s.get("rlen_sum", 0) + int(rec["rlen"].sum().item())
        s["rows_computed"] += B * (rec["tile"][0] * rec["tile"][1] if Xp <= 1024 else Xp)
        s["kernel_ms"] += rec["kernel_ms"]
        s["around_ms"] += rec["around_ms"]
    for s in by.values():
        s["median_B"] = statistics.median(s.pop("B"))
        s["mean_alen"] = s.pop("alen_sum") / s["items"]
        s["mean_rlen"] = s.pop("rlen_sum") / s["items"]
    top = max(by.values(), key=lambda s: s["cells"], default=None)
    return {
        "by_shape": by,
        "median_items_per_launch": statistics.median([r["allele"].shape[0] for r in launches])
        if launches else 0,
        "most_cells": None if top is None else [top["median_B"], top["Xp"], top["Yp"]],
    }


@contextlib.contextmanager
def timed_pairhmm():
    """Device time and work items of every K2 / K3 / K4 launch inside the
    block, from CUDA events recorded through ``pairhmm_column.launch_hook``
    (counts untouched): "ms" brackets the library call alone, "around_ms"
    the whole launch helper with its host work; the launches also by shape
    (:func:`shape_record`, "shapes"), and the first RERUN launches of each
    ("first")."""
    import torch

    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    launches = []

    def hook(stage, fn_name, allele, read, tensors, tile):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if stage == "enter":
            launches.append({"fn": fn_name, "allele": allele, "read": read,
                             "alen": tensors[1], "rlen": tensors[2], "tile": tile,
                             "args": (allele, read, *tensors), "events": [ev]})
        else:
            launches[-1]["events"].append(ev)

    phc.launch_hook = hook
    stats = {}
    try:
        yield stats
    finally:
        phc.launch_hook = None
        torch.cuda.synchronize()
        launches = [r for r in launches if len(r["events"]) == 3]  # B = 0 launches nothing
        for rec in launches:
            enter, call, ret = rec.pop("events")
            rec["kernel_ms"] = call.elapsed_time(ret)
            rec["around_ms"] = enter.elapsed_time(ret)
        for fn in ("vlt_pairhmm_exact", "vlt_pairhmm_general", "vlt_pairhmm_positional"):
            mine = [r for r in launches if r["fn"] == fn]
            stats[fn] = {"ms": sum(r["kernel_ms"] for r in mine),
                         "around_ms": sum(r["around_ms"] for r in mine),
                         "forwards": sum(r["allele"].shape[0] for r in mine)}
        stats["shapes"], stats["first"] = {}, {}
        for fn in ("vlt_pairhmm_exact", "vlt_pairhmm_general", "vlt_pairhmm_positional"):
            mine = [r for r in launches if r["fn"] == fn]
            stats["shapes"][fn] = shape_record(mine)
            stats["first"][fn] = mine[:RERUN]
        stats["all"] = launches


def warm_rerun(records, path):
    """The first main-path launches of a pair-HMM entry again, each back to
    back after a warm-up (through the launch helper, so not counted), beside
    their in-path kernel time: how much of that is the card starting from
    idle.  Their inputs are saved to ``path`` (for
    scripts/torch_k3_variants.py --real)."""
    import torch

    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    warm = [cuda_ms(lambda: phc._launch(r["fn"], *r["args"], tile=r["tile"]), 10, ahead=True)
            for r in records]
    torch.save([[t.cpu() for t in r["args"]] for r in records], path)
    return {"launches": len(records), "items": sum(r["allele"].shape[0] for r in records),
            "in_path_kernel_ms": sum(r["kernel_ms"] for r in records),
            "warm_kernel_ms": sum(warm)}


def head_of_vcf(src, dst, n):
    """The header and the first n records of a VCF."""
    kept, lines = 0, []
    for line in Path(src).read_text().splitlines(keepends=True):
        if not line.startswith("#"):
            if kept == n:
                break
            kept += 1
        lines.append(line)
    Path(dst).write_text("".join(lines))


def vcf_head(text, n):
    """The header and the first n records of a VCF text."""
    lines = text.splitlines(keepends=True)
    n_head = sum(1 for ln in lines if ln.startswith("#"))
    return "".join(lines[: n_head + n])


def cli_quiet(argv, stdout=None):
    """cli.run with the progress log and (unless captured) stdout muted."""
    import io

    from varlociraptor_tpu_torch import cli

    with contextlib.redirect_stderr(io.StringIO()), \
            contextlib.redirect_stdout(stdout or io.StringIO()):
        return cli.run(argv)


def estimate_props(w, path, secs):
    """``estimate alignment-properties`` on the normal BAM into ``path``."""
    import io

    from varlociraptor_tpu_torch.estimation.alignment_properties import AlignmentProperties

    buf = io.StringIO()
    t0 = time.perf_counter()
    rc = cli_quiet(["estimate", "alignment-properties", w["fasta"], "--bam", w["normal"]],
                   stdout=buf)
    secs["estimate"] = time.perf_counter() - t0
    if rc != 0:
        raise PhaseError(f"estimate returned {rc}")
    path.write_text(buf.getvalue())
    return AlignmentProperties.from_json(buf.getvalue())


def preprocess_samples(w, work, props_path, secs, device, flags=()):
    """``preprocess variants`` of both samples; returns their files and the
    K2 / K3 / K4 forwards of each sample."""
    obs, forwards, rc = {}, {}, 0
    for sample in ("tumor", "normal"):
        obs[sample] = str(work / f"{sample}.obs")
        before = pairhmm_forwards()
        t0 = time.perf_counter()
        rc |= cli_quiet(["preprocess", "variants", w["fasta"], "--bam", w[sample],
                         "--candidates", w["candidates"], "--output", obs[sample],
                         "--sample-name", sample, "--alignment-properties",
                         str(props_path), "--device", device, *flags])
        secs[f"preprocess_{sample}"] = time.perf_counter() - t0
        forwards[sample] = {k: v - before[k] for k, v in pairhmm_forwards().items()}
    if rc != 0:
        raise PhaseError(f"preprocess: the CLI returned {rc}")
    return obs, forwards


def cpu_recheck(w, work, props_path, obs, secs, n_cpu, mode="exact"):
    """The first n_cpu loci of each sample again on the CPU (the plain
    kernels), same chunk; the observations must equal the card's."""
    from varlociraptor_tpu_torch.estimation.alignment_properties import AlignmentProperties
    from varlociraptor_tpu_torch.calling.preprocess import PreprocessOptions, preprocess
    from varlociraptor_tpu_torch.compare import compare_observation_files

    head_cpu = work / f"candidates_{n_cpu}.vcf"
    head_of_vcf(w["candidates"], head_cpu, n_cpu)
    cmp = {}
    for sample in ("tumor", "normal"):
        cpu_obs = work / f"{sample}.cpu.obs"
        t0 = time.perf_counter()
        preprocess(str(head_cpu), w[sample], w["fasta"], str(cpu_obs), sample_name=sample,
                   alignment_properties=AlignmentProperties.from_json(props_path.read_text()),
                   options=PreprocessOptions(device_chunk=64, log_mode="silent",
                                             pairhmm_mode=mode),
                   device="cpu")
        secs[f"cpu_preprocess_{sample}_{n_cpu}"] = time.perf_counter() - t0
        problems, info = compare_observation_files(cpu_obs, obs[sample], n=n_cpu)
        if problems:
            raise PhaseError(f"preprocess cuda vs cpu ({sample}): " + "; ".join(problems[:3]))
        cmp[sample] = info
    return cmp


def call_and_filter(w, work, obs, secs, res, device):
    """Call on the card, control the FDR, score against the world's truth."""
    import numpy as np

    from varlociraptor_tpu_torch.compare import vcf_record_keys
    from varlociraptor_tpu_torch.ops import ll_classes as k1

    calls, kept = work / "pp_calls.vcf", work / "pp_somatic.fdr.vcf"
    k1.ll_classes.launches = 0
    t0 = time.perf_counter()
    rc = cli_quiet(["call", "variants", "tumor-normal", "--tumor", obs["tumor"],
                    "--normal", obs["normal"], "--purity", "0.75", "--device", device,
                    "--output", str(calls)])
    secs["call"] = time.perf_counter() - t0
    res["k1_launches"] = k1.ll_classes.launches
    t0 = time.perf_counter()
    rc |= cli_quiet(["filter-calls", "control-fdr", str(calls), "--events", "somatic_tumor",
                     "--fdr", "0.05", "--output", str(kept)])
    secs["fdr"] = time.perf_counter() - t0
    if rc != 0:
        raise PhaseError(f"{res['phase']}: call / filter returned {rc}")
    n_called = len(vcf_record_keys(calls.read_text()))
    kept_pos = np.array([int(k[1]) - 1 for k in vcf_record_keys(kept.read_text())], np.int64)
    truth = w["truth"]
    res.update(
        records_called=n_called, somatic_kept=int(len(kept_pos)),
        planted_somatic_recall=float(np.isin(truth["somatic"], kept_pos).mean()),
        germline_kept=int(np.isin(truth["germline"], kept_pos).sum()),
        decoys_kept=int(np.isin(truth["decoy"], kept_pos).sum()),
    )
    if "in_run" in truth:
        in_run = truth["somatic"][np.isin(truth["somatic"], truth["in_run"])]
        res["planted_somatic_in_run_recall"] = float(np.isin(in_run, kept_pos).mean())
    if n_called != w["n_candidates"] or len(kept_pos) == 0 or res["k1_launches"] == 0:
        raise PhaseError(f"{res['phase']}: called {n_called} of {w['n_candidates']}, kept "
                         f"{len(kept_pos)}, K1 launches {res['k1_launches']}")


def pairhmm_times(res, hmm_stats, pre_s):
    names = {"K2": "vlt_pairhmm_exact", "K3": "vlt_pairhmm_general",
             "K4": "vlt_pairhmm_positional"}
    res["pairhmm_device_ms"] = {k: hmm_stats[v]["ms"] for k, v in names.items()}
    res["pairhmm_around_launch_ms"] = {k: hmm_stats[v]["around_ms"] for k, v in names.items()}
    res["pairhmm_forwards"] = {k: hmm_stats[v]["forwards"] for k, v in names.items()}
    res["pairhmm_device_share_of_preprocess"] = (
        sum(res["pairhmm_device_ms"].values()) / 1e3 / pre_s)


def reset_pairhmm_counts():
    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    for fn in (phc.exact_forward, phc.general_forward, phc.positional_forward):
        fn.launches = 0


def pairhmm_counts():
    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    return {"exact": phc.exact_forward.launches, "general": phc.general_forward.launches,
            "positional": phc.positional_forward.launches}


def pairhmm_forwards():
    """The work items of the K2 / K3 / K4 launches counted so far."""
    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    return {"exact": phc.exact_forward.forwards, "general": phc.general_forward.forwards,
            "positional": phc.positional_forward.forwards}


# builds a synth_preprocess_world in a process of its own: argv = (repo,
# output directory, JSON keyword arguments); pickles the world's dict next to
# its files and prints its seconds
_WORLD_JOB = """
import json, pickle, sys, time
sys.path.insert(0, sys.argv[1])
from varlociraptor_tpu_torch.bench_utils import synth_preprocess_world
t0 = time.perf_counter()
w = synth_preprocess_world(sys.argv[2], **json.loads(sys.argv[3]))
with open(sys.argv[2] + "/world.pkl", "wb") as f:
    pickle.dump(w, f)
print(json.dumps({"seconds": time.perf_counter() - t0}))
"""
_JOBS = []  # the world processes started, stopped at exit


class WorldJob:
    """``synth_preprocess_world(out_dir, **kw)`` in a process of its own (the
    no-JAX guard on its PYTHONPATH), started ahead of the phase that needs
    the world, so that the host simulates its reads while the card phases
    before it run.  The world is the one an in-process call builds: the
    draws depend on the arguments alone."""

    def __init__(self, out_dir, **kw):
        self.out_dir, self.kw = Path(out_dir), kw
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WORLD_JOB, str(ROOT), str(self.out_dir), json.dumps(kw)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        _JOBS.append(self.proc)

    def result(self, secs):
        """The world's dict; ``secs`` gains the generation's seconds and the
        wait for it."""
        import pickle

        t0 = time.perf_counter()
        out, err = self.proc.communicate()
        secs["world_wait"] = time.perf_counter() - t0
        if self.proc.returncode != 0:
            raise PhaseError(f"world job failed ({self.proc.returncode}): {err[-2000:]}")
        secs["world"] = json.loads(out.strip().splitlines()[-1])["seconds"]
        with open(self.out_dir / "world.pkl", "rb") as f:
            return pickle.load(f)


def stop_world_jobs():
    for proc in _JOBS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# phases (d)'s and (e)'s worlds (2 Mb, 2,000 candidates; (e)'s with
# homopolymer=True)
PREPROCESS_WORLD = dict(seed=0, genome_len=2_000_000, n_germline=1000, n_somatic=500,
                        n_decoy=500)


def phase_preprocess(work, world, n_rerun=200, n_cpu=192, device="cuda"):
    """(d): estimate, preprocess and call on ``world`` (a ``WorldJob``)."""
    import json as _json

    import numpy as np

    from varlociraptor_tpu_torch.estimation.alignment_properties import (
        AlignmentProperties,
        GapParams,
    )
    from varlociraptor_tpu_torch.io import native

    res = {"phase": "preprocess", "native_host_library": native.available()}
    secs = res["seconds"] = {}
    w = world.result(secs)
    n = w["n_candidates"]
    res.update(genome_len=world.kw["genome_len"], candidates=n, reads=w["reads"])

    # 1. estimate on the normal BAM, then preprocess both samples on the card
    props_path = work / "props.json"
    props = estimate_props(w, props_path, secs)
    gp = props.gap_params
    finite = [np.isfinite(gp.prob_insertion_extend_artifact),
              np.isfinite(gp.prob_deletion_extend_artifact)]
    res["gap_model"] = {"estimated": _json.loads(props.to_json())["gap_params"],
                        "kernel": "K2" if not any(finite) else "K3"}
    reset_pairhmm_counts()  # main path
    with timed_pairhmm() as hmm_stats:
        obs, forwards = preprocess_samples(w, work, props_path, secs, device)
        # 2. the other gap model on the first n_rerun normal candidates
        other = AlignmentProperties.from_json(props.to_json())
        other.gap_params = (GapParams() if any(finite) else GapParams(*GAP_ONT))
        other_path = work / "props_other.json"
        other_path.write_text(other.to_json())
        head = work / f"candidates_{n_rerun}.vcf"
        head_of_vcf(w["candidates"], head, n_rerun)
        t0 = time.perf_counter()
        rc = cli_quiet(["preprocess", "variants", w["fasta"], "--bam", w["normal"],
                        "--candidates", str(head), "--output", str(work / "normal_other.obs"),
                        "--alignment-properties", str(other_path), "--device", device])
        secs["preprocess_normal_other_model"] = time.perf_counter() - t0
    launches = pairhmm_counts()
    if rc != 0:
        raise PhaseError(f"preprocess: the CLI returned {rc}")
    if min(launches["exact"], launches["general"]) == 0 or launches["positional"]:
        raise PhaseError(f"preprocess: K2 and K3 must launch, K4 not: {launches}")
    res["pairhmm_launches"] = launches
    res["pairhmm_forwards_by_sample"] = forwards
    res["loci_per_s"] = {s: n / secs[f"preprocess_{s}"] for s in ("tumor", "normal")}
    pairhmm_times(res, hmm_stats, secs["preprocess_tumor"] + secs["preprocess_normal"]
                  + secs["preprocess_normal_other_model"])
    res["k2_shapes"] = hmm_stats["shapes"]["vlt_pairhmm_exact"]
    res["k2_warm_rerun"] = warm_rerun(hmm_stats["first"]["vlt_pairhmm_exact"],
                                      work / K2_LAUNCHES_FILE)
    res["k3_shapes"] = hmm_stats["shapes"]["vlt_pairhmm_general"]
    res["k3_warm_rerun"] = warm_rerun(hmm_stats["first"]["vlt_pairhmm_general"],
                                      work / K3_LAUNCHES_FILE)

    # 3. the first n_cpu loci again on the CPU (plain K2 / K3), same chunk
    res["cuda_vs_cpu"] = cpu_recheck(w, work, props_path, obs, secs, n_cpu)
    # 4. call on the card and control the FDR
    call_and_filter(w, work, obs, secs, res, device)
    return res, launches, serial_tumor(w, props_path, obs, forwards, secs)


def serial_tumor(w, props_path, obs, forwards, secs):
    """What phase (g) compares its --threads runs of the tumor with."""
    return {"world": w, "props": props_path, "obs": obs["tumor"],
            "forwards": forwards["tumor"], "seconds": secs["preprocess_tumor"]}


def phase_homopolymer(work, world, n_cpu=192, device="cuda"):
    """(e): phase (d)'s pipeline on the homopolymer world (a ``WorldJob``),
    in the homopolymer pair-HMM mode (K4 with the estimated hop params)."""
    import json as _json

    import numpy as np


    res = {"phase": "homopolymer"}
    secs = res["seconds"] = {}
    w = world.result(secs)
    n = w["n_candidates"]
    res.update(genome_len=world.kw["genome_len"], candidates=n, reads=w["reads"],
               indels_in_runs=int(len(w["truth"]["in_run"])))

    # 1. estimate: hop params for every base, or K4 would not be reached
    props_path = work / "props.json"
    props = estimate_props(w, props_path, secs)
    est = _json.loads(props.to_json())
    res["hop_params"], res["gap_params"] = est["hop_params"], est["gap_params"]
    hop = props.hop_params
    values = [hop.prob_seq_homopolymer, hop.prob_ref_homopolymer,
              hop.prob_seq_extend_homopolymer, hop.prob_ref_extend_homopolymer]
    if not np.isfinite(np.asarray(values, np.float64)).all():
        raise PhaseError(f"homopolymer: the estimate gave non-finite hop params {values}")

    # 2. preprocess both samples on the card in homopolymer mode
    reset_pairhmm_counts()  # main path
    with timed_pairhmm() as hmm_stats:
        obs, forwards = preprocess_samples(w, work, props_path, secs, device,
                                           flags=("--pairhmm-mode", "homopolymer"))
    launches = pairhmm_counts()
    if launches["positional"] == 0 or launches["exact"] or launches["general"]:
        raise PhaseError(f"homopolymer: K4 must launch, K2 and K3 not: {launches}")
    res["pairhmm_launches"] = launches
    res["pairhmm_forwards_by_sample"] = forwards
    res["loci_per_s"] = {s: n / secs[f"preprocess_{s}"] for s in ("tumor", "normal")}
    pairhmm_times(res, hmm_stats, secs["preprocess_tumor"] + secs["preprocess_normal"])
    res["k4_shapes"] = hmm_stats["shapes"]["vlt_pairhmm_positional"]
    res["k4_warm_rerun"] = warm_rerun(hmm_stats["first"]["vlt_pairhmm_positional"],
                                      work / K4_LAUNCHES_FILE)

    # 3. the first n_cpu loci again on the CPU (plain K4)
    res["cuda_vs_cpu"] = cpu_recheck(w, work, props_path, obs, secs, n_cpu,
                                     mode="homopolymer")
    # 4. call on the card and control the FDR
    call_and_filter(w, work, obs, secs, res, device)
    return res, launches, serial_tumor(w, props_path, obs, forwards, secs)


# phase (f): loci per engine call of each mode, the plain recheck's head, and
# the CLI's loci and CPU re-call
MODE_LOCI = {"full_prior": 8192, "l2fc": 8192, "cyclic": 2048}
MODES_PLAIN = 1024
MODES_CLI_LOCI = 20_000
MODES_CLI_CPU = 2000


@contextlib.contextmanager
def k1_shapes():
    """K1's launches by shape (rows N, classes U, reads D), from the
    wrapper's launch hook."""
    from collections import Counter

    from varlociraptor_tpu_torch.ops import ll_classes as k1

    shapes = Counter()

    def hook(N, U, D):
        shapes[(N, U, D)] += 1

    k1.launch_hook = hook
    try:
        yield shapes
    finally:
        k1.launch_hook = None


def mode_run(name, engine, n_loci, table):
    """(f1)-(f3): one engine mode on ``n_loci`` loci at depth 64, timed with
    CUDA events after a warm-up (every output copied to the host), its K1
    launches and loop steps per call over three calls, peak memory, and the
    first MODES_PLAIN loci re-run with the plain K1 and compared."""
    import numpy as np
    import torch

    from varlociraptor_tpu_torch.bench_utils import engine_inputs
    from varlociraptor_tpu_torch.compare import compare_outputs
    from varlociraptor_tpu_torch.ops import lfc_star as ls
    from varlociraptor_tpu_torch.ops import ll_classes as k1
    from varlociraptor_tpu_torch.ops import lse_contract as lc

    inputs = engine_inputs(engine, n_loci=n_loci, depth=64, seed=0)
    pj = idx = None
    if table is not None:  # one table, every locus's row
        pj, idx = table[None], np.zeros(n_loci, np.int64)
    engine.run(*inputs, ln_prior_joint=pj, ln_prior_idx=idx)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.ll_classes.launches = 0  # main path starts here
    lc.lse_contract.launches = 0
    ls.lfc_star.launches = 0
    engine.loop_steps = 0
    ms, wall, runs = [], [], 3
    with k1_shapes() as shapes, assemble_passes(
            f"engine_modes {name}", engine.device.type == "cuda") as passes:
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = engine.run(*inputs, ln_prior_joint=pj, ln_prior_idx=idx)  # outputs on the host
            end.record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            ms.append(start.elapsed_time(end))
    launches, contractions = k1.ll_classes.launches, lc.lse_contract.launches
    steps, star = engine.loop_steps, ls.lfc_star.launches
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or launches != sum(shapes.values()) or launches % runs:
        raise PhaseError(f"engine_modes {name}: K1 launched {launches} times in {runs} calls")
    if contractions % runs:
        raise PhaseError(f"engine_modes {name}: the contraction launched {contractions} "
                         f"times in {runs} calls")
    if passes["passes"] != runs:
        raise PhaseError(f"engine_modes {name}: {passes['passes']} assemble passes in "
                         f"{runs} calls")
    # the star l2fc integral: one launch a star branch, no plain loop step
    if star != runs * len(engine.branch_lfc_masks) * (name == "l2fc") or (
            name == "l2fc" and steps):
        raise PhaseError(f"engine_modes {name}: the star l2fc kernel launched {star} times "
                         f"and the loop took {steps} steps in {runs} calls")
    if out["posteriors"].shape != (n_loci, engine.n_events) or out["af"].shape != (
            n_loci, engine.n_samples):
        raise PhaseError(f"engine_modes {name}: output shapes")
    if not (np.isfinite(out["marginal"]).all() and np.isfinite(out["af"]).all()):
        raise PhaseError(f"engine_modes {name}: non-finite marginal or af")
    if any(np.isnan(np.asarray(v, dtype=np.float64)).any() for v in out.values()):
        raise PhaseError(f"engine_modes {name}: NaN in the outputs")
    sub = [np.asarray(x)[:MODES_PLAIN] for x in inputs]
    t0 = time.perf_counter()
    with plain_k1():
        plain = engine.run(*sub, ln_prior_joint=pj,
                           ln_prior_idx=None if idx is None else idx[:MODES_PLAIN])
    plain_s = time.perf_counter() - t0
    head = {k: v[:MODES_PLAIN] for k, v in out.items()}
    problems, info = compare_outputs(plain, head, grid_values=engine.grid.values)
    if problems:
        raise PhaseError(f"engine_modes {name} vs plain K1: " + "; ".join(problems[:5]))
    best = min(ms)
    return {
        "mode": name, "n_loci": n_loci, "samples": engine.n_samples,
        "branches": engine.n_branches,
        "lfc_branches": len(engine.branch_lfc_masks),
        "ms": ms, "wall_s": wall, "loci_per_s": n_loci / (best / 1e3),
        "peak_mem_gb": peak / 2**30,
        "k1_launches_per_call": launches // runs,
        "k1_shapes": [{"N": N, "U": U, "D": D, "per_call": c // runs}
                      for (N, U, D), c in sorted(shapes.items())],
        "loop_steps_per_call": steps // runs,
        "contractions_per_call": contractions // runs,
        "lfc_star_launches_per_call": star // runs,
        "assemble_passes_per_call": passes["passes"] // runs,
        "vs_plain_head": {"n_loci": min(MODES_PLAIN, n_loci), "seconds": plain_s,
                          "max_rel": info["max_rel"], "af_max": info["af_max"],
                          "af_flat": len(info["af_flat"]),
                          "topk_swaps": len(info["topk_swaps"])},
    }, launches, contractions


def prior_table_seconds():
    """Host seconds of the --full-prior table of the de novo trio
    (``bench_utils.TRIO_DENOVO_SCENARIO``: Mendelian inheritance, somatic
    rates, resolution 0.01: 101^3 cells), computed over the whole grid at
    once (``ops/prior_table.py``)."""
    import numpy as np

    from varlociraptor_tpu_torch.bench_utils import (
        TRIO_DENOVO_SCENARIO, full_prior_table, scenario_engine)

    scenario, trio = scenario_engine(TRIO_DENOVO_SCENARIO, 0.01, device="cuda")
    table, secs = full_prior_table(scenario, trio)
    if not np.isfinite(table).any():
        raise PhaseError("engine_modes: the trio prior table has no finite cell")
    return {"cells": int(table.size), "shape": list(table.shape), "host_s": secs,
            "us_per_cell": secs / table.size * 1e6}


def phase_engine_modes(work):
    """(f): the engine's l2fc, cyclic-contamination and --full-prior modes,
    then ``call variants generic --full-prior`` through the CLI."""
    import numpy as np

    from varlociraptor_tpu_torch import bench_utils as bu
    from varlociraptor_tpu_torch import cli
    from varlociraptor_tpu_torch.compare import compare_vcf_text, vcf_record_keys
    from varlociraptor_tpu_torch.ops import ll_classes as k1
    from varlociraptor_tpu_torch.ops import lse_contract as lc

    res = {"phase": "engine_modes", "depth": 64, "resolution": 0.01, "modes": []}
    launches, contractions = 0, {}
    scenario, tn = bu.tumor_normal_engine(resolution=0.01, purity=0.75, device="cuda")
    table, table_s = bu.full_prior_table(scenario, tn)
    res["prior_table_tumor_normal"] = {"cells": int(table.size), "shape": list(table.shape),
                                       "host_s": table_s}
    for name, build, tbl in (
        ("full_prior", lambda: tn, table),
        ("l2fc", lambda: bu.l2fc_engine(device="cuda"), None),
        ("cyclic", lambda: bu.cyclic_engine(device="cuda"), None),
    ):
        rec, n, contractions[name] = mode_run(name, build(), MODE_LOCI[name], tbl)
        res["modes"].append(rec)
        launches += n
    # the pure cycle has no tree node: its cyclic reducer contracts nothing
    if not (contractions["full_prior"] and contractions["l2fc"]):
        raise PhaseError(f"engine_modes: the contraction must launch in full_prior and "
                         f"l2fc: {contractions}")

    # the CLI: tumor-normal with --full-prior, then its head on the CPU
    tumor, normal, _ = bu.synth_observation_files(work / "fp_obs", n_loci=MODES_CLI_LOCI, seed=1)
    yaml_path = work / "tumor_normal.yaml"
    yaml_path.write_text(json.dumps(scenario.doc))  # JSON is YAML
    calls = work / "fp_calls.vcf"
    argv = ["call", "variants", "generic", "--scenario", str(yaml_path), "--obs",
            f"tumor={tumor}", f"normal={normal}", "--full-prior"]
    k1.ll_classes.launches = 0  # main path starts here
    lc.lse_contract.launches = 0
    with assemble_passes("engine_modes cli") as passes:
        t0 = time.perf_counter()
        rc = cli.run(argv + ["--device", "cuda", "--output", str(calls)])
        call_s = time.perf_counter() - t0
    cli_launches, contractions["cli"] = k1.ll_classes.launches, lc.lse_contract.launches
    calls_text = calls.read_text()
    n_called = len(vcf_record_keys(calls_text))
    if rc != 0 or n_called != MODES_CLI_LOCI or cli_launches == 0 or not contractions["cli"]:
        raise PhaseError(f"engine_modes cli: rc {rc}, {n_called} records, "
                         f"{cli_launches} K1 launches, {contractions['cli']} contractions")
    launches += cli_launches
    sub_dir = work / "fp_obs2k"
    sub_dir.mkdir(parents=True, exist_ok=True)
    t2k, n2k = subset_files([tumor, normal], sub_dir, MODES_CLI_CPU)
    calls_cpu = work / "fp_calls_cpu.vcf"
    t0 = time.perf_counter()
    rc = cli.run(["call", "variants", "generic", "--scenario", str(yaml_path), "--obs",
                  f"tumor={t2k}", f"normal={n2k}", "--full-prior", "--device", "cpu",
                  "--output", str(calls_cpu)])
    cpu_s = time.perf_counter() - t0
    problems, swapped = compare_vcf_text(calls_cpu.read_text(),
                                         vcf_head(calls_text, MODES_CLI_CPU))
    if rc != 0 or problems:
        raise PhaseError("engine_modes cli cuda vs cpu VCF: " + "; ".join(problems[:3]))
    windows = -(-MODES_CLI_LOCI // 1024)
    res["cli"] = {
        "n_loci": MODES_CLI_LOCI, "records": n_called, "call_s": call_s,
        "call_loci_per_s": MODES_CLI_LOCI / call_s, "k1_launches": cli_launches,
        "k1_launches_per_window": cli_launches / windows,
        "contractions_per_window": contractions["cli"] / windows,
        "assemble_passes": passes["passes"],
        "cpu_2k_call_s": cpu_s, "cpu_vs_cuda_topk_swapped_lines": swapped,
    }
    res["prior_table_trio"] = prior_table_seconds()
    res["k1_launches"] = launches
    res["contractions"] = contractions
    return res, launches


# phase (g): worker processes of the --threads runs (each capped by the cores
# this process may run on), and of the one homopolymer run
THREADS = (2, 4, 8)
THREADS_HOMOPOLYMER = 4
PAIRHMM_KINDS = ("exact", "general", "positional")


def threads_run(serial, work, n_threads, kernel, flags=()):
    """``preprocess variants --threads n_threads --device cuda`` of the tumor
    against the serial run of phase (d) or (e): every record equal within
    the tolerance of ``compare_observation_files``, the workers' forwards
    summed equal to the serial run's, ``kernel`` launched in every worker
    and nothing launched in the parent."""
    from varlociraptor_tpu_torch.calling import preprocess as pp
    from varlociraptor_tpu_torch.compare import compare_observation_files

    w = serial["world"]
    out = work / f"tumor.threads{n_threads}.obs"
    reports = []
    pp.worker_hook = reports.extend
    reset_pairhmm_counts()  # main path: the parent's counts must stay 0
    t0 = time.perf_counter()
    try:
        rc = cli_quiet(["preprocess", "variants", w["fasta"], "--bam", w["tumor"],
                        "--candidates", w["candidates"], "--output", str(out),
                        "--sample-name", "tumor", "--alignment-properties",
                        str(serial["props"]), "--threads", str(n_threads),
                        "--device", "cuda", *flags])
    finally:
        pp.worker_hook = None
    wall = time.perf_counter() - t0
    parent = pairhmm_counts()
    launches = {k: sum(r["launches"][k] for r in reports) for k in PAIRHMM_KINDS}
    forwards = {k: sum(r["forwards"][k] for r in reports) for k in PAIRHMM_KINDS}
    problems, info = compare_observation_files(serial["obs"], out)
    res = {"threads": n_threads, "mode": flags[-1] if flags else "exact", "seconds": wall,
           "loci_per_s": w["n_candidates"] / wall,
           "serial_loci_per_s": w["n_candidates"] / serial["seconds"],
           "workers": len(reports), "shards": [r["shard"] for r in reports],
           "worker_entered_s": [r["entered_s"] for r in reports],
           "worker_ready_s": [r["ready_s"] for r in reports],
           "worker_end_s": [r["end_s"] for r in reports],
           "worker_devices": sorted({r["device"] for r in reports}),
           "pairhmm_launches": launches, "pairhmm_forwards": forwards,
           "serial_forwards": serial["forwards"], "vs_serial": info}
    if rc != 0 or len(reports) != n_threads or any(parent.values()):
        raise PhaseError(f"threads {n_threads}: rc {rc}, {len(reports)} workers, "
                         f"parent launches {parent}")
    if problems or info["records"] != w["n_candidates"]:
        raise PhaseError(f"threads {n_threads} vs serial: " + "; ".join(problems[:3]))
    if forwards != serial["forwards"]:
        raise PhaseError(f"threads {n_threads}: forwards {forwards}, serial "
                         f"{serial['forwards']}")
    if any(r["launches"][kernel] == 0 or not r["device"].startswith("cuda")
           for r in reports):
        raise PhaseError(f"threads {n_threads}: {kernel} did not launch on the card "
                         f"in every worker: {reports}")
    return res


def phase_preprocess_threads(work, serial, serial_hp):
    """(g): the tumors of phases (d) and (e) again with --threads."""
    import os

    cores = len(os.sched_getaffinity(0))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # what a worker's start costs before the port runs: a bare interpreter
    # that imports torch
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch"], check=True)
    res = {"phase": "preprocess_threads", "cpu_count": os.cpu_count(),
           "affinity_cores": cores, "card": smi,
           "import_torch_s": time.perf_counter() - t0, "runs": []}
    for n_threads in sorted({min(n, cores) for n in THREADS}):
        res["runs"].append(threads_run(serial, work, n_threads, "general"))
    res["runs"].append(threads_run(serial_hp, work / "homopolymer",
                                   min(THREADS_HOMOPOLYMER, cores), "positional",
                                   ("--pairhmm-mode", "homopolymer")))
    launches = {k: sum(run["pairhmm_launches"][k] for run in res["runs"])
                for k in PAIRHMM_KINDS}
    res["pairhmm_launches"] = launches
    return res, launches


# phase (h): the legacy per-WorkItem caller (h1), reference-format
# observation files (h2), estimate contamination (h3) and call cnvs (h4).
# h1's loci and its CPU re-call; h2's CPU re-call of the head of each .bcf;
# h3's dedicated synthetic files (about LEGACY_CONTAM_LOCI * 0.3 loci pass
# the contamination candidate filter); the K1 launches of h1 held to the
# plain version at their own shapes
LEGACY_LOCI = 20000
LEGACY_CPU = 2000
BCF_CPU = 512
LEGACY_CONTAM_LOCI = 2000
LEGACY_CONTAM_SOMATIC = 0.3
LEGACY_CONTAM_MIN_PASSED = 500
LEGACY_K1_CHECKED = 4
# h3: the card's contamination log densities against the CPU's, per row,
# in nats.  Each AFD entry is an int16 deci-PHRED density, so float32 and
# float64 sums can round one entry a step (ln(10) / 100 = 0.023 nats)
# apart; the measured worst row was 0.031 nats over 610 informative
# variants (NVIDIA H100 80GB HBM3, 700 W).  The limit is about nine such
# steps, 6.5 times that reading (the worst case, two steps per variant, is
# the bound of tests/test_torch_contamination.py at its 24 loci)
CONTAM_LOG_DENSITY_TOL = 0.2
# card against CPU calls of phase (d)'s world (h2): its loci carry
# log-likelihood sums of up to ~1,000 nats (PROB_GERMLINE_HOM reaches
# 1,164 PHRED = 268 nats of posterior), where one float32 rounding moves a
# sum by up to 6e-8 * 1,000 = 6e-5 nats; a posterior is a difference of
# log-sum-exps over such sums, four roundings: 2.4e-4 nats = 1.0e-3 PHRED.
# So PHRED and AF within 1e-3 * max(1, |x|) (compare_vcf_text's default
# 1.1e-4 holds the synthetic loci of h1, whose sums are smaller)
WORLD_VCF_TOL = 1e-3


@contextlib.contextmanager
def legacy_call(on=True):
    """``VLT_LEGACY_CALL=1`` (the legacy per-WorkItem path) for the calls
    inside, or unset."""
    import os

    saved = os.environ.pop("VLT_LEGACY_CALL", None)
    if on:
        os.environ["VLT_LEGACY_CALL"] = "1"
    try:
        yield
    finally:
        os.environ.pop("VLT_LEGACY_CALL", None)
        if saved is not None:
            os.environ["VLT_LEGACY_CALL"] = saved


@contextlib.contextmanager
def k1_first_inputs(store, n):
    """Keep copies of the inputs of K1's first ``n`` launches.  The wrapper
    still launches them; it counts each under its module name, so the count
    lives on the stand-in meanwhile and goes back to the wrapper after."""
    from varlociraptor_tpu_torch.ops import ll_classes as k1

    kernel = k1.ll_classes

    def capture(*args):
        if len(store) < n:
            store.append(tuple(t.clone() for t in args))
        return kernel(*args)

    capture.launches = kernel.launches
    k1.ll_classes = capture
    try:
        yield
    finally:
        k1.ll_classes = kernel
        kernel.launches = capture.launches


def timed_call(argv):
    """``call variants ...`` on the card through the CLI: (seconds, K1
    launches, K1 shapes)."""
    from varlociraptor_tpu_torch.ops import ll_classes as k1

    # looked up on the module, not bound once: inside k1_first_inputs the
    # count sits on its stand-in
    k1.ll_classes.launches = 0  # main path starts here
    with k1_shapes() as shapes:
        t0 = time.perf_counter()
        rc = cli_quiet(argv + ["--device", "cuda"])
        secs = time.perf_counter() - t0
    if rc != 0:
        raise PhaseError(f"legacy_and_estimates: {argv[:3]} returned {rc}")
    return secs, k1.ll_classes.launches, [{"N": N, "U": U, "D": D, "launches": c}
                                          for (N, U, D), c in sorted(shapes.items())]


def info_max_rel(text_a, text_b):
    """The largest difference of the INFO numbers (PROB_*) of two VCFs of
    the same records, relative to max(1, |x|)."""
    import re

    num = re.compile(r"-?\d+\.\d+")
    worst = 0.0
    for a, b in zip(text_a.splitlines(), text_b.splitlines()):
        if a.startswith("#") or a == b:
            continue
        for x, y in zip(num.findall(a.split("\t")[7]), num.findall(b.split("\t")[7])):
            worst = max(worst, abs(float(x) - float(y)) / max(1.0, abs(float(x))))
    return worst


def cuda_vs_cpu_vcf(name, gpu_text, cpu_text, n, rel_tol=None):
    from varlociraptor_tpu_torch.compare import VCF_REL_TOL, compare_vcf_text

    rel_tol = VCF_REL_TOL if rel_tol is None else rel_tol
    head = vcf_head(gpu_text, n)
    problems, swapped = compare_vcf_text(cpu_text, head, rel_tol=rel_tol)
    if problems:
        raise PhaseError(f"legacy_and_estimates {name} cuda vs cpu: " + "; ".join(problems[:3]))
    return {"n_loci": n, "rel_tol": rel_tol, "info_max_rel": info_max_rel(cpu_text, head),
            "topk_swapped_lines": swapped}


def k1_legacy_check(captured):
    """K1 against its plain version at the legacy path's own launch
    shapes (the first launches of h1), timed as phase (a) times it."""
    import numpy as np

    from varlociraptor_tpu_torch.ops.ll_classes import ll_classes, ll_classes_reference

    out = []
    for args in captured:
        g = ll_classes(*args).cpu().numpy()
        r = ll_classes_reference(*args).cpu().numpy()
        fin = np.isfinite(r)
        if not np.array_equal(np.isfinite(g), fin):
            raise PhaseError("K1 legacy shapes: finiteness differs from the plain version")
        err = np.abs(g[fin] - r[fin])
        rel = float(np.max(err / np.maximum(1, np.abs(r[fin])))) if fin.any() else 0.0
        if not rel <= K1_TOL:
            raise PhaseError(f"K1 legacy shapes: rel err {rel} > {K1_TOL}")
        N, D = args[0].shape
        out.append({"N": N, "U": int(args[4].shape[0]), "D": D,
                    "max_abs_err": float(err.max()) if fin.any() else 0.0,
                    "max_rel_err": rel,
                    "ms": cuda_ms(lambda: ll_classes(*args), 20),
                    "plain_ms": cuda_ms(lambda: ll_classes_reference(*args), 5),
                    **k1_roofline(args)})
    return out


def phase_legacy_and_estimates(work, cli_files, pp_files, truth):
    """(h): the legacy caller on the first LEGACY_LOCI loci of phase
    (c)'s files; phase (d)'s observations re-encoded into the reference's
    v15 .bcf and called on both paths; ``estimate contamination``;
    ``call cnvs`` on phase (d)'s and phase (c)'s calls.  Every card output
    against a ``--device cpu`` run."""
    import io

    import numpy as np

    from varlociraptor_tpu_torch import cli
    from varlociraptor_tpu_torch.bench_utils import (
        reference_observation_file,
        synth_observation_files,
    )
    from varlociraptor_tpu_torch.calling import cnvs
    from varlociraptor_tpu_torch.calling.call import DEFAULT_BATCH
    from varlociraptor_tpu_torch.compare import vcf_record_keys
    from varlociraptor_tpu_torch.estimation import contamination
    from varlociraptor_tpu_torch.ops import ll_classes as k1

    res = {"phase": "legacy_and_estimates"}
    launches = {}

    # (h1) the legacy caller (VLT_LEGACY_CALL=1) on the CLI's synthetic loci
    h1 = res["legacy_call"] = {"n_loci": LEGACY_LOCI}
    sub = work / "legacy_obs"
    sub.mkdir(parents=True, exist_ok=True)
    t, n = subset_files([cli_files["tumor"], cli_files["normal"]], sub, LEGACY_LOCI)
    calls = work / "legacy_calls.vcf"
    argv = ["call", "variants", "tumor-normal", "--tumor", t, "--normal", n,
            "--purity", "0.75", "--output", str(calls)]
    captured = []
    with legacy_call(), k1_first_inputs(captured, LEGACY_K1_CHECKED):
        h1["seconds"], launches["legacy_call"], h1["k1_shapes"] = timed_call(argv)
    text = calls.read_text()
    batches = -(-LEGACY_LOCI // DEFAULT_BATCH)
    h1.update(records=len(vcf_record_keys(text)), loci_per_s=LEGACY_LOCI / h1["seconds"],
              call_batches=batches, k1_launches=launches["legacy_call"],
              k1_launches_per_call_batch=launches["legacy_call"] / batches)
    if h1["records"] != LEGACY_LOCI or launches["legacy_call"] != 2 * batches:
        raise PhaseError(f"legacy_call: {h1['records']} records, K1 launched "
                         f"{launches['legacy_call']} times in {batches} batches")
    cpu_sub = work / "legacy_obs_cpu"
    cpu_sub.mkdir(parents=True, exist_ok=True)
    tc, nc = subset_files([t, n], cpu_sub, LEGACY_CPU)
    cpu_calls = work / "legacy_calls_cpu.vcf"
    with legacy_call():
        t0 = time.perf_counter()
        rc = cli_quiet(["call", "variants", "tumor-normal", "--tumor", tc, "--normal", nc,
                        "--purity", "0.75", "--device", "cpu", "--output", str(cpu_calls)])
        h1["cpu_call_s"] = time.perf_counter() - t0
    if rc != 0:
        raise PhaseError(f"legacy_call cpu: rc {rc}")
    h1["cuda_vs_cpu"] = cuda_vs_cpu_vcf("legacy_call", text, cpu_calls.read_text(), LEGACY_CPU)
    h1["k1_vs_plain"] = k1_legacy_check(captured)

    # (h2) phase (d)'s observations as the reference's v15 .bcf
    h2 = res["reference_bcf"] = {}
    bdir = work / "v15"
    bdir.mkdir(parents=True, exist_ok=True)
    bcf, head = {}, {}
    t0 = time.perf_counter()
    for s in ("tumor", "normal"):
        bcf[s] = reference_observation_file(pp_files[s], bdir / f"{s}.obs.bcf")
        head[s] = reference_observation_file(pp_files[s], bdir / f"{s}.head.obs.bcf", BCF_CPU)
    h2["encode_s"] = time.perf_counter() - t0
    n_loci = len(vcf_record_keys(Path(pp_files["calls"]).read_text()))
    for path_name, legacy in (("columnar", False), ("legacy", True)):
        rec = h2[path_name] = {"n_loci": n_loci}
        out = bdir / f"calls_{path_name}.vcf"
        argv = ["call", "variants", "tumor-normal", "--tumor", bcf["tumor"], "--normal",
                bcf["normal"], "--purity", "0.75", "--output", str(out)]
        with legacy_call(legacy):
            rec["seconds"], launches[f"bcf_{path_name}"], rec["k1_shapes"] = timed_call(argv)
            cpu_out = bdir / f"calls_{path_name}_cpu.vcf"
            t0 = time.perf_counter()
            rc = cli_quiet(["call", "variants", "tumor-normal", "--tumor", head["tumor"],
                            "--normal", head["normal"], "--purity", "0.75", "--device",
                            "cpu", "--output", str(cpu_out)])
            rec["cpu_call_s"] = time.perf_counter() - t0
        text = out.read_text()
        rec.update(records=len(vcf_record_keys(text)), loci_per_s=n_loci / rec["seconds"],
                   k1_launches=launches[f"bcf_{path_name}"])
        if rc != 0 or rec["records"] != n_loci or rec["k1_launches"] == 0:
            raise PhaseError(f"reference_bcf {path_name}: cpu rc {rc}, {rec['records']} of "
                             f"{n_loci} records, K1 launches {rec['k1_launches']}")
        rec["cuda_vs_cpu"] = cuda_vs_cpu_vcf(f"reference_bcf {path_name}", text,
                                             cpu_out.read_text(), min(BCF_CPU, n_loci),
                                             WORLD_VCF_TOL)
        kept = bdir / f"somatic_{path_name}.fdr.vcf"
        t0 = time.perf_counter()
        rc = cli_quiet(["filter-calls", "control-fdr", str(out), "--events", "somatic_tumor",
                        "--fdr", "0.05", "--output", str(kept)])
        rec["fdr_s"] = time.perf_counter() - t0
        kept_pos = np.array([int(k[1]) - 1 for k in vcf_record_keys(kept.read_text())],
                            np.int64)
        rec.update(somatic_kept=int(len(kept_pos)),
                   planted_somatic_recall=float(np.isin(truth["somatic"], kept_pos).mean()),
                   decoys_kept=int(np.isin(truth["decoy"], kept_pos).sum()))
        if rc != 0 or len(kept_pos) == 0:
            raise PhaseError(f"reference_bcf {path_name}: control-fdr rc {rc}, "
                             f"kept {len(kept_pos)}")

    # (h3) estimate contamination on dedicated synthetic files
    h3 = res["contamination"] = {"n_loci": LEGACY_CONTAM_LOCI,
                                  "frac_somatic": LEGACY_CONTAM_SOMATIC}
    ct, cn, _ = synth_observation_files(work / "contam_obs", n_loci=LEGACY_CONTAM_LOCI, seed=2,
                                        frac_somatic=LEGACY_CONTAM_SOMATIC)
    make_filter = contamination._make_candidate_filter
    passed = []

    def counting_filter(sample_idx, cont_idx):
        keep = make_filter(sample_idx, cont_idx)

        def f(item):
            ok = keep(item)
            passed.append(ok)
            return ok
        return f

    tsv = {}
    contamination._make_candidate_filter = counting_filter
    try:
        for dev in ("cuda", "cpu"):
            passed.clear()
            out = work / f"contamination_{dev}.tsv"
            err = io.StringIO()
            k1.ll_classes.launches = 0  # main path starts here
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
                rc = cli.run(["estimate", "contamination", "--sample", ct, "--contaminant",
                              cn, "--device", dev, "--output", str(out)])
            secs = time.perf_counter() - t0
            if dev == "cuda":
                launches["contamination"] = k1.ll_classes.launches
                h3.update(seconds=secs, loci_passed=int(sum(passed)),
                          k1_launches=launches["contamination"],
                          summary=err.getvalue().strip().splitlines()[-1])
            else:
                h3["cpu_seconds"] = secs
            if rc != 0:
                raise PhaseError(f"contamination on {dev}: rc {rc}")
            tsv[dev] = out.read_text().splitlines()
    finally:
        contamination._make_candidate_filter = make_filter
    print(f"legacy_and_estimates: {h3['loci_passed']} loci passed the contamination "
          "candidate filter", flush=True)
    n_var = int(h3["summary"].split("(")[-1].split()[0])
    h3["informative_variants"] = n_var
    tol = CONTAM_LOG_DENSITY_TOL
    rows_g = [r.split("\t") for r in tsv["cuda"][1:]]
    rows_c = [r.split("\t") for r in tsv["cpu"][1:]]
    dens = {tuple(r[:2]): float(r[2]) for r in rows_c}
    worst = 0.0
    for r in rows_g:
        x, y = dens.get(tuple(r[:2]), -1.0), float(r[2])
        if (x == 0.0) != (y == 0.0) or x < 0:
            raise PhaseError(f"contamination cuda vs cpu: row {r} vs {x}")
        if x > 0:
            worst = max(worst, abs(math.log(y) - math.log(x)))
    h3.update(top_row=rows_g[0][:2], max_abs_log_density_diff=worst, tol=tol)
    if (tsv["cuda"][0] != tsv["cpu"][0] or rows_g[0][:2] != rows_c[0][:2]
            or len(rows_g) != len(rows_c) or worst > tol
            or h3["loci_passed"] < LEGACY_CONTAM_MIN_PASSED or launches["contamination"] == 0):
        raise PhaseError(f"contamination cuda vs cpu: top {rows_g[0]} vs {rows_c[0]}, "
                         f"log density diff {worst} (tol {tol}), {h3['loci_passed']} loci "
                         f"passed, K1 launches {launches['contamination']}")

    # (h4) call cnvs on phase (d)'s calls (with the depth channel) and on
    # phase (c)'s calls
    h4 = res["cnvs"] = []
    viterbi = cnvs.viterbi
    for name, files, extra in (
        ("preprocess", pp_files, ["--tumor-obs", pp_files["tumor"],
                                  "--normal-obs", pp_files["normal"]]),
        ("cli", cli_files, []),
    ):
        rec = {"calls": name, "records_in": len(vcf_record_keys(Path(files["calls"]).read_text()))}
        texts = {}
        for dev in ("cuda", "cpu"):
            stats = {"calls": 0, "steps": 0, "seconds": 0.0}

            def timed_viterbi(obs, mbf, device="cuda", stats=stats):
                t0 = time.perf_counter()
                path = viterbi(obs, mbf, device)
                stats["seconds"] += time.perf_counter() - t0
                stats["calls"] += 1
                stats["steps"] += obs.shape[0] - 1
                return path

            out = work / f"cnvs_{name}_{dev}.vcf"
            cnvs.viterbi = timed_viterbi
            try:
                t0 = time.perf_counter()
                rc = cli_quiet(["call", "cnvs", files["calls"], "--purity", "0.75",
                                "--device", dev, "--output", str(out), *extra])
                secs = time.perf_counter() - t0
            finally:
                cnvs.viterbi = viterbi
            if rc != 0:
                raise PhaseError(f"cnvs {name} on {dev}: rc {rc}")
            texts[dev] = out.read_text()
            tag = "" if dev == "cuda" else "cpu_"
            rec.update({f"{tag}seconds": secs, f"{tag}viterbi_s": stats["seconds"],
                        f"{tag}viterbi_calls": stats["calls"],
                        f"{tag}viterbi_steps": stats["steps"]})
        rec["segments"] = len(vcf_record_keys(texts["cuda"]))
        rec["viterbi_us_per_step"] = rec["viterbi_s"] / max(rec["viterbi_steps"], 1) * 1e6
        if texts["cuda"] != texts["cpu"] or rec["viterbi_steps"] == 0:
            raise PhaseError(f"cnvs {name}: the card's VCF differs from the cpu's "
                             f"(or no Viterbi step ran: {rec['viterbi_steps']})")
        h4.append(rec)

    res["k1_launches"] = launches
    return res, sum(launches.values()), h1["k1_vs_plain"]

# phase (i): the all-kinds world.  A 500 kb contig with ~100
# candidates of each kind would take ~5 minutes (a first run at 250 kb and
# 50 per kind took 184 s: each testcase capture estimates both full BAMs,
# 7 x 9.5 s); cut to KINDS_GENOME bases and KINDS_PER_KIND candidates of each
# kind, to keep the phase near two minutes of command time
KINDS_GENOME = 150_000
KINDS_INDELS = {"n_germline": 30, "n_somatic": 15, "n_decoy": 15, "n_snv": 15}
KINDS_PER_KIND = 30
KINDS_RATCHET = 10
KINDS_CPU = 24  # the CPU re-preprocess covers at least this many loci of each kind
KINDS_CHECKED = 4  # launches of panels other than 128 x 128 held to the plain kernel
# phase (i)'s kernel-against-plain check at the main path's own launches:
# K23_TOL for every item whose forward log-likelihood lies above
# FORWARD_FLOOR nats in either version; below it in both, the item passes.
# In float32 linear space a path that sits ln(1e-16 / 1.4e-45) = 66 nats
# below its column's best cell underflows (the rescale keeps that cell
# above 1e-16, denormals end at 1.4e-45), so a read that aligns nowhere
# owes its value to whichever far paths the order of roundings (the
# kernel's FMAs and scans, torch's elementwise ops) let survive.  Measured
# on the card (NVIDIA H100 80GB HBM3, 700 W): of 86,539 K3 items of the
# all-kinds world, every one out of K23_TOL lay at or below -101.4 nats
# (the deepest differed by 19 nats), where the plain float32 version is
# itself 0.4-7.2 nats off a float64 evaluation of the same recurrence.
# These reads say nothing for either allele (compare.OBS_FLOOR).
FORWARD_FLOOR = -100.0


def kinds_head(candidates, kinds, n_min):
    """The smallest head of the candidate file that ends just before a BND
    group (or at the file's end) and holds ``n_min`` records of every kind
    (all of a kind that has fewer).  Preprocess flushes its pending chunk of
    loci at a group's first breakend, so the card's run finished the head's
    chunks with the same loci, and the same alignment-property ratchet, that
    a --device cpu re-preprocess of the head at the same chunk finishes."""
    from varlociraptor_tpu_torch.calling.variants import collect_variants
    from varlociraptor_tpu_torch.io.vcf import open_variant_file

    per_record = [collect_variants(r) for r in open_variant_file(candidates)]
    total = {k: sum(i.kind == k for infos in per_record for i in infos) for k in kinds}
    seen, groups = dict.fromkeys(kinds, 0), set()
    for n, infos in enumerate(per_record):
        starts = [i for i in infos if i.kind == "breakend" and i.haplotype not in groups]
        if starts and all(seen[k] >= min(n_min, total[k]) for k in kinds):
            return n, seen
        groups.update(i.haplotype for i in starts)
        for i in infos:
            if i.kind in seen:
                seen[i.kind] += 1
    return len(per_record), seen


def odd_panels_vs_plain(launches):
    """The first KINDS_CHECKED K2 / K3 launches of each whose panel is not
    128 x 128, again through the launch helper (not counted) against the
    plain kernel on their own inputs (K23_TOL above FORWARD_FLOOR), timed
    with their bound."""
    import numpy as np

    from varlociraptor_tpu_torch.ops import pairhmm_column as phc

    plain = {"vlt_pairhmm_exact": ("exact", phc.exact_forward_reference),
             "vlt_pairhmm_general": ("general", phc.general_forward_reference)}
    out, worst = [], {"exact": 0.0, "general": 0.0}
    for fn, (kind, ref_fn) in plain.items():
        odd = [r for r in launches if r["fn"] == fn
               and (r["allele"].shape[1], r["read"].shape[1]) != (128, 128)][:KINDS_CHECKED]
        for r in odd:
            args, tile = r["args"], r["tile"]
            g = phc._launch(fn, *args, tile=tile).cpu().numpy()
            p = ref_fn(*args).cpu().numpy()
            if not (np.array_equal(np.isfinite(g), np.isfinite(p))
                    and np.array_equal(g <= -1e30, p <= -1e30)):
                raise PhaseError(f"{kind} at {tuple(args[0].shape)}: finiteness or -1e30 "
                                 "items differ from the plain version")
            live = p > -1e30
            deep = live & (g < FORWARD_FLOOR) & (p < FORWARD_FLOOR)
            held = live & ~deep
            err = np.abs(g[held] - p[held])
            rel = float(np.max(err / np.maximum(1.0, np.abs(p[held])))) if held.any() else 0.0
            if not rel <= K23_TOL:
                raise PhaseError(f"{kind} at {tuple(args[0].shape)}, tile {tile}: rel err "
                                 f"{rel} > {K23_TOL} above {FORWARD_FLOOR} nats")
            B, Xp = args[0].shape
            case = {"kernel": kind, "B": B, "Xp": Xp, "Yp": args[1].shape[1],
                    "tile": list(tile), "max_abs_err": float(err.max()) if held.any() else 0.0,
                    "max_rel_err": rel, "items_below_floor": int(deep.sum()),
                    "worst_below_floor": float(np.max(np.abs(g[deep] - p[deep])))
                    if deep.any() else 0.0,
                    "ms": cuda_ms(lambda: phc._launch(fn, *args, tile=tile), 10, ahead=True),
                    "plain_ms": cuda_ms(lambda: ref_fn(*args), 2)}
            cells = (args[3].double() * args[4].double()).sum().item()
            case.update(roofline(OPS_PER_CELL[kind] * cells,
                                 sum(x.numel() * x.element_size() for x in args) + 4 * B))
            worst[kind] = max(worst[kind], case["max_abs_err"])
            out.append(case)
    return out, worst


def capture_testcase(w, obs, scenario, prefix, locus):
    """``call variants generic --testcase-*`` of the port's CLI on the card."""
    t0 = time.perf_counter()
    rc = cli_quiet(["call", "variants", "generic", "--scenario", str(scenario), "--obs",
                    f"tumor={obs['tumor']}", f"normal={obs['normal']}",
                    "--output", str(prefix) + ".calls.vcf", "--testcase-locus", locus,
                    "--testcase-prefix", str(prefix), "--device", "cuda"])
    if rc != 0:
        raise PhaseError(f"kinds_and_testcases: the capture at {locus} returned {rc}")
    return time.perf_counter() - t0


def event_tie(a, b, rel_tol):
    """Whether two calls VCF records differ only where the call's events
    tie: with every sample's AF and AFD masked they agree within
    ``rel_tol``, and two or more events share the smallest PROB_ value,
    printed alike in both.  The MAP event, and with it each sample's MAP AF
    and AFD, then turns on the last bit of float32 sums that run in another
    order on the card and on the CPU (PERF.md, PR 18: a duplication with
    one uninformative read, where a float64 sum of the same terms sides
    with the card)."""
    from varlociraptor_tpu_torch.compare import compare_vcf_text

    def masked(line):
        f = line.split("\t")
        keys = f[8].split(":")
        f[9:] = [":".join("." if k in ("AF", "AFD") else v for k, v in zip(keys, s.split(":")))
                 for s in f[9:]]
        return "\t".join(f)

    def top(line):
        probs = dict(kv.split("=", 1) for kv in line.split("\t")[7].split(";")
                     if kv.startswith("PROB_"))
        best = min(probs.values(), key=float)
        return sorted(k for k, v in probs.items() if v == best)

    fa, fb = a.split("\t"), b.split("\t")
    if a.startswith("#") or len(fa) < 10 or len(fa) != len(fb) or fa[8] != fb[8]:
        return False
    problems, _ = compare_vcf_text(masked(a), masked(b), rel_tol=rel_tol)
    return not problems and len(top(a)) >= 2 and top(a) == top(b)


def phase_kinds_and_testcases(work):
    """(i): (i1) the all-kinds world through estimate, preprocess on the
    card (and the normal's head again with the other gap model, so that K2
    and K3 both launch; their launches by shape, the first launches of
    other panels than 128 x 128 against the plain kernel), a --device cpu
    re-preprocess of the head, call and FDR; (i2) one testcase per kind
    captured with the port's CLI and replayed on the card and on the CPU."""
    import contextlib as _contextlib
    import io

    import numpy as np
    import yaml

    from varlociraptor_tpu_torch.bench_utils import OTHER_KINDS, synth_preprocess_world
    from varlociraptor_tpu_torch.calling.preprocess import PreprocessOptions, preprocess
    from varlociraptor_tpu_torch.compare import compare_observation_files, compare_vcf_text
    from varlociraptor_tpu_torch.estimation.alignment_properties import (
        AlignmentProperties,
        GapParams,
    )
    from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
    from varlociraptor_tpu_torch.ops import ll_classes as k1
    from varlociraptor_tpu_torch.testcase import Testcase

    res = {"phase": "kinds_and_testcases"}
    secs = res["seconds"] = {}
    t0 = time.perf_counter()
    w = synth_preprocess_world(work / "world", seed=0, genome_len=KINDS_GENOME, **KINDS_INDELS,
                               kinds=KINDS_PER_KIND, ratchet=KINDS_RATCHET,
                               methylation=KINDS_PER_KIND)
    secs["world"] = time.perf_counter() - t0
    n = w["n_candidates"]
    res.update(genome_len=KINDS_GENOME, candidates=n, reads=w["reads"])

    # (i1) estimate on the normal, preprocess both samples on the card
    props_path = work / "props.json"
    props = estimate_props(w, props_path, secs)
    start = {k: getattr(props, k) for k in
             ("max_del_cigar_len", "max_ins_cigar_len", "frac_max_softclip")}
    res["estimate"] = {"maxima": start, "gap_params": json.loads(props.to_json())["gap_params"]}
    head_n, per_kind = kinds_head(w["candidates"], OTHER_KINDS, KINDS_CPU)
    head = work / f"candidates_{head_n}.vcf"
    head_of_vcf(w["candidates"], head, head_n)
    finite = np.isfinite(props.gap_params.prob_insertion_extend_artifact) or \
        np.isfinite(props.gap_params.prob_deletion_extend_artifact)
    other = AlignmentProperties.from_json(props.to_json())
    other.gap_params = GapParams() if finite else GapParams(*GAP_ONT)
    other_path = work / "props_other.json"
    other_path.write_text(other.to_json())
    reset_pairhmm_counts()  # main path: (i1)
    k1.ll_classes.launches = 0
    with timed_pairhmm() as hmm_stats:
        obs, forwards = preprocess_samples(w, work, props_path, secs, "cuda")
        t0 = time.perf_counter()
        rc = cli_quiet(["preprocess", "variants", w["fasta"], "--bam", w["normal"],
                        "--candidates", str(head), "--output", str(work / "normal_other.obs"),
                        "--alignment-properties", str(other_path), "--device", "cuda"])
        secs["preprocess_normal_head_other_model"] = time.perf_counter() - t0
    launches = pairhmm_counts()
    if rc != 0 or min(launches["exact"], launches["general"]) == 0 or launches["positional"]:
        raise PhaseError(f"kinds_and_testcases: K2 and K3 must launch, K4 not: {launches}")
    res["pairhmm_launches"] = dict(launches)
    res["pairhmm_forwards_by_sample"] = forwards
    res["loci_per_s"] = {s: n / secs[f"preprocess_{s}"] for s in ("tumor", "normal")}
    pairhmm_times(res, hmm_stats, secs["preprocess_tumor"] + secs["preprocess_normal"]
                  + secs["preprocess_normal_head_other_model"])
    res["k2_shapes"] = hmm_stats["shapes"]["vlt_pairhmm_exact"]
    res["k3_shapes"] = hmm_stats["shapes"]["vlt_pairhmm_general"]
    res["odd_panels_vs_plain"], worst = odd_panels_vs_plain(hmm_stats["all"])
    if not res["odd_panels_vs_plain"]:
        raise PhaseError("kinds_and_testcases: no K2 / K3 launch had another panel than 128 x 128")
    del hmm_stats

    # the head of the candidates again on the CPU, every kind compared alone
    res["cuda_vs_cpu"] = {"head_records": head_n, "per_kind": per_kind, "samples": {}}
    for sample in ("tumor", "normal"):
        cpu_obs = work / f"{sample}.cpu.obs"
        t0 = time.perf_counter()
        preprocess(str(head), w[sample], w["fasta"], str(cpu_obs), sample_name=sample,
                   alignment_properties=AlignmentProperties.from_json(props_path.read_text()),
                   options=PreprocessOptions(device_chunk=64, log_mode="silent"), device="cpu")
        secs[f"cpu_preprocess_{sample}_{head_n}"] = time.perf_counter() - t0
        by_kind = {}
        for kind in OTHER_KINDS + ("deletion", "insertion", "snv"):
            problems, info = compare_observation_files(cpu_obs, obs[sample], n=head_n,
                                                       kinds={kind})
            if problems:
                raise PhaseError(f"kinds_and_testcases cuda vs cpu ({sample}, {kind}): "
                                 + "; ".join(problems[:3]))
            by_kind[kind] = info
        res["cuda_vs_cpu"]["samples"][sample] = by_kind
    # call on the card, FDR, recall of the planted somatic indels
    call_and_filter(w, work, obs, secs, res, "cuda")
    launches["ll_classes"] = k1.ll_classes.launches

    # (i2) one testcase per kind: captured on the card, replayed on both
    scenario = work / "scenario.yaml"
    scenario.write_text(yaml.safe_dump(tumor_normal_scenario(0.75).doc))
    res["testcases"] = {}

    def counts():
        return {**pairhmm_counts(), "ll_classes": k1.ll_classes.launches}

    for kind in OTHER_KINDS:
        t = w["truth"]["kinds"][kind]
        planted = t.get("germline", []) + t.get("somatic", []) + t.get("methylated", [])
        locus = f"chr1:{min(planted or t['decoy']) + 1}"
        prefix = work / f"testcase_{kind}"
        before = counts()
        rec = {"locus": locus, "capture_s": capture_testcase(w, obs, scenario, prefix, locus)}
        rec["capture_launches"] = {k: v - before[k] for k, v in counts().items()}
        texts = {}
        for dev in ("cuda", "cpu"):
            before = counts()
            t0 = time.perf_counter()
            with _contextlib.redirect_stderr(io.StringIO()), timed_pairhmm() as replay:
                records, _ = Testcase(prefix).run(work / f"replay_{kind}_{dev}", device=dev)
            rec[f"{dev}_replay_s"] = time.perf_counter() - t0
            texts[dev] = (work / f"replay_{kind}_{dev}" / "calls.vcf").read_text()
            if dev == "cuda":
                rec["records"] = len(records)
                rec["replay_launches"] = {k: v - before[k] for k, v in counts().items()}
                rec["replay_shapes"] = {fn.split("_")[-1]: sorted(s["by_shape"]) for fn, s in
                                        replay["shapes"].items() if s["by_shape"]}
        # 30x loci of a BAM world, as phase (h2)'s: WORLD_VCF_TOL; a record
        # whose events tie may take another MAP event (event_tie)
        problems, _ = compare_vcf_text(texts["cpu"], texts["cuda"], rel_tol=WORLD_VCF_TOL)
        if problems and len(texts["cpu"].splitlines()) == len(texts["cuda"].splitlines()):
            pairs = [(n, a, b) for n, (a, b) in enumerate(
                zip(texts["cpu"].splitlines(), texts["cuda"].splitlines()), 1) if a != b]
            ties = [n for n, a, b in pairs if compare_vcf_text(a, b, rel_tol=WORLD_VCF_TOL)[0]
                    and event_tie(a, b, WORLD_VCF_TOL)]
            problems = [p for p in problems if int(p.split(":")[0][5:]) not in ties]
            rec["event_tie_lines"] = ties
        if problems or not rec["records"] or not rec["replay_launches"]["ll_classes"]:
            raise PhaseError(f"kinds_and_testcases replay {kind}: {problems[:3]}, "
                             f"{rec['records']} records, launches {rec['replay_launches']}")
        for k in ("exact", "general", "ll_classes"):
            launches[k] += rec["capture_launches"][k] + rec["replay_launches"][k]
        res["testcases"][kind] = rec
    replayed = sum(r["replay_launches"]["exact"] + r["replay_launches"]["general"]
                   for r in res["testcases"].values())
    if replayed == 0:
        raise PhaseError("kinds_and_testcases: no K2 / K3 launch in the card's replays")
    res["launches"] = launches
    return res, launches, worst


# phase (j): locus sharding.  (j2) the engine cell's inputs in two shards on
# cuda:0; (j3) SHARDED_RANKS ranks over gloo sharing the one card, each with
# its region half of phase (c)'s files and its half of j2's batch; (j4) NCCL
# in a world of one rank.  No machine this script runs on has a second card
# for NCCL between ranks.
SHARDED_LOCI = 32768
J2_REPEATS = 3
SHARDED_RANKS = 2
RANK_TIMEOUT_S = 600
NCCL_ACROSS_CARDS = ("not run: one card on this machine; NCCL between ranks "
                     "needs a card per rank")


@contextlib.contextmanager
def shard_launches(per_shard):
    """K1's launches per shard: inside this block every call of the
    engine's ``run`` / ``run_compact`` is one shard of ``run_sharded`` /
    ``run_sharded_compact``, and appends the launches it made to
    ``per_shard``."""
    from varlociraptor_tpu_torch.ops import ll_classes as k1
    from varlociraptor_tpu_torch.ops.posterior import PosteriorEngine

    saved = {name: getattr(PosteriorEngine, name)
             for name in ("run", "run_compact")}

    def counted(fn):
        def run(self, *args, **kwargs):
            n0 = k1.ll_classes.launches
            try:
                return fn(self, *args, **kwargs)
            finally:
                per_shard.append(k1.ll_classes.launches - n0)
        return run

    for name, fn in saved.items():
        setattr(PosteriorEngine, name, counted(fn))
    try:
        yield per_shard
    finally:
        for name, fn in saved.items():
            setattr(PosteriorEngine, name, fn)


def sharded_rank(spec):
    """One rank of phase (j3), in a process of its own started with
    torchrun's environment: ``distributed_mesh(backend="gloo")`` (its shard
    is the one card), its half of j2's batch through ``run_sharded`` (timed
    after a warm-up run), its
    region half of phase (c)'s files through ``call_generic(mesh=...)``,
    ``control_fdr_sharded`` over its calls, and a timed gather of as many
    float64 rows as it called.  Prints one ``RANK_REPORT`` JSON line."""
    import os

    entered = time.time()
    sys.meta_path.insert(0, refuse_jax)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    from varlociraptor_tpu_torch import _build
    from varlociraptor_tpu_torch.bench_utils import engine_inputs, tumor_normal_engine
    from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
    from varlociraptor_tpu_torch.filtration.fdr import control_fdr_sharded
    from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
    from varlociraptor_tpu_torch.ops import ll_classes as k1
    from varlociraptor_tpu_torch.ops import lse_contract as lc
    from varlociraptor_tpu_torch.parallel.sharding import (
        all_gather_rows, distributed_mesh, run_sharded,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    rep = {"rank": rank, "entered_s": entered - spec["spawned"]}
    device = spec["device"]
    mesh = distributed_mesh(None if device == "cuda" else [device], backend="gloo")
    if device == "cuda":
        _build.load()
    rep.update(ready_s=time.time() - spec["spawned"], backend=mesh.backend,
               devices=[str(d) for d in mesh.devices], world_size=mesh.world_size)
    _, engine = tumor_normal_engine(resolution=0.01, purity=0.75, device=device)
    half = spec["loci"] // mesh.world_size
    inputs = engine_inputs(engine, n_loci=spec["loci"], depth=64, seed=0)
    local = [np.asarray(a)[rank * half:(rank + 1) * half] for a in inputs]
    run_sharded(engine, mesh, *local)  # warm-up: first launches, allocator growth
    per_shard = []
    with shard_launches(per_shard):
        k1.ll_classes.launches = lc.lse_contract.launches = 0  # main path
        with assemble_passes(f"rank {rank} engine", device == "cuda") as passes:
            t0 = time.perf_counter()
            out = run_sharded(engine, mesh, *local)
            engine_s = time.perf_counter() - t0
        rep.update(engine_s=engine_s, engine_loci_per_s=half / engine_s,
                   engine_k1_launches=k1.ll_classes.launches,
                   engine_k1_per_shard=list(per_shard),
                   engine_contractions=lc.lse_contract.launches,
                   engine_assemble_passes=passes["passes"])
        per_shard.clear()
        k1.ll_classes.launches = lc.lse_contract.launches = 0  # main path
        obs = dict(zip(("tumor", "normal"), spec["obs"][rank]))
        with assemble_passes(f"rank {rank} call", device == "cuda") as passes:
            t0 = time.perf_counter()
            n = call_generic(tumor_normal_scenario(0.75), obs, spec["calls"][rank],
                             CallOptions(), mesh=mesh, device=device)
            call_s = time.perf_counter() - t0
    rep.update(call_loci=n, call_s=call_s, call_loci_per_s=n / call_s,
               call_k1_launches=k1.ll_classes.launches, call_shards=len(per_shard),
               call_contractions=lc.lse_contract.launches,
               call_k1_per_shard=sorted(set(per_shard)),
               call_assemble_passes=passes["passes"])
    t0 = time.perf_counter()
    rep["fdr_kept"] = control_fdr_sharded([spec["calls"][rank]], spec["kept"][rank],
                                          ["somatic_tumor"], alpha=0.05, mesh=mesh)
    rep["fdr_s"] = time.perf_counter() - t0
    rows = np.random.default_rng(rank).standard_normal((n, 2))
    t0 = time.perf_counter()
    gathered = all_gather_rows(rows, mesh)
    rep.update(gather_s=time.perf_counter() - t0, gather_rows=len(gathered))
    np.savez(spec["out"][rank], **out)
    loaded = [m for m in sys.modules if m.split(".")[0] in REFUSED
              and sys.modules[m] is not None]
    rep.update(jax_modules=loaded, end_s=time.time() - spec["spawned"])
    dist.destroy_process_group()
    print("RANK_REPORT " + json.dumps(rep), flush=True)


def run_ranks(spec, work):
    """Start SHARDED_RANKS ranks of :func:`sharded_rank` on the card with
    torchrun's environment; their reports in rank order.  A rank that fails
    or outlasts RANK_TIMEOUT_S fails the phase; every rank is ended."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.sharded_rank(json.loads(sys.argv[2]))")
    spec = {**spec, "spawned": time.time()}
    procs, logs = [], []
    try:
        for rank in range(SHARDED_RANKS):
            env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": port,
                   "WORLD_SIZE": str(SHARDED_RANKS), "RANK": str(rank),
                   "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(SHARDED_RANKS)}
            logs.append(work / f"rank{rank}.log")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(ROOT), json.dumps(spec)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.time() + RANK_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        raise PhaseError(f"sharded: a rank ran past {RANK_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        text = log.read_text()
        line = next((ln for ln in text.splitlines() if ln.startswith("RANK_REPORT ")), None)
        if p.returncode != 0 or line is None:
            raise PhaseError(f"sharded: rank {rank} returned {p.returncode}:\n{text[-3000:]}")
        reports.append(json.loads(line[len("RANK_REPORT "):]))
    return reports


def nccl_one_rank():
    """(j4): a world of one rank over NCCL on cuda:0 (torchrun's environment
    set here): ``all_gather_rows`` of float64 rows whose float32 rounding
    differs must come back bit for bit."""
    import os
    import socket

    import numpy as np
    import torch.distributed as dist

    from varlociraptor_tpu_torch.parallel.sharding import all_gather_rows, distributed_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": port, "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh = distributed_mesh()
        rows = np.random.default_rng(4).standard_normal((100_000, 2)) / 3.0
        if np.array_equal(rows.astype(np.float32).astype(np.float64), rows):
            raise PhaseError("sharded: the NCCL rows do not test float64")
        all_gather_rows(rows[:10], mesh)  # warm-up: the communicator
        t0 = time.perf_counter()
        got = all_gather_rows(rows, mesh)
        secs = time.perf_counter() - t0
        if mesh.backend != "nccl" or got.dtype != np.float64 or got.tobytes() != rows.tobytes():
            raise PhaseError(f"sharded: NCCL all_gather_rows over {mesh.backend} is not bit-exact")
        return {"backend": mesh.backend, "devices": [str(d) for d in mesh.devices],
                "rows": len(rows), "seconds": secs, "bit_exact": True}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_sharded(work, engine, cli_files, device="cuda"):
    """(j): ``dryrun_multichip`` over every card (j1), the engine cell's
    inputs in two shards on cuda:0 against ``engine.run`` (j2), two ranks
    over gloo on the one card against j2's single run and phase (c)'s call
    and FDR (j3), and NCCL in a world of one rank (j4).  ``device="cpu"``
    rehearses it (j1 on two CPU shards, the ranks on the CPU)."""
    import numpy as np
    import torch

    from varlociraptor_tpu_torch.bench_utils import engine_inputs, region_shards
    from varlociraptor_tpu_torch.compare import compare_outputs, compare_vcf_text, vcf_record_keys
    from varlociraptor_tpu_torch.ops import ll_classes as k1
    from varlociraptor_tpu_torch.ops import lse_contract as lc
    from varlociraptor_tpu_torch.parallel.dryrun import dryrun_multichip
    from varlociraptor_tpu_torch.parallel.sharding import locus_mesh, run_sharded

    res = {"phase": "sharded", "nccl_across_cards": NCCL_ACROSS_CARDS}
    launches, contractions = {}, {}

    # (j1) the dry run over every card of the machine
    k1.ll_classes.launches = lc.lse_contract.launches = 0  # main path
    t0 = time.perf_counter()
    try:
        with assemble_passes("sharded dryrun", device == "cuda") as passes:
            res["dryrun"] = dryrun_multichip(
                torch.cuda.device_count() if device == "cuda" else 2, device, work / "dryrun")
    except AssertionError as e:
        raise PhaseError(f"sharded: dryrun_multichip: {e}") from None
    assembled = {"dryrun": passes["passes"]}
    res["dryrun"]["seconds"] = time.perf_counter() - t0
    launches["dryrun"] = k1.ll_classes.launches
    contractions["dryrun"] = lc.lse_contract.launches

    # (j2) one process, two shards on cuda:0
    # each timed as phase (b) times the engine: best of J2_REPEATS after a
    # warm-up call, every output copied to the host
    inputs = engine_inputs(engine, n_loci=SHARDED_LOCI, depth=64, seed=0)
    mesh = locus_mesh([f"{device}:0" if device == "cuda" else device] * 2)
    engine.run(*inputs)
    single_s = []
    for _ in range(J2_REPEATS):
        t0 = time.perf_counter()
        single = engine.run(*inputs)
        single_s.append(time.perf_counter() - t0)
    run_sharded(engine, mesh, *inputs)
    sharded_s, per_shard = [], []
    with shard_launches(per_shard), assemble_passes("sharded two_shards",
                                                             device == "cuda") as passes:
        k1.ll_classes.launches = lc.lse_contract.launches = 0  # main path
        for _ in range(J2_REPEATS):
            t0 = time.perf_counter()
            out = run_sharded(engine, mesh, *inputs)
            sharded_s.append(time.perf_counter() - t0)
    assembled["two_shards"] = passes["passes"]
    launches["two_shards"] = k1.ll_classes.launches
    contractions["two_shards"] = lc.lse_contract.launches
    problems, info = compare_outputs(single, out)
    if problems:
        raise PhaseError("sharded: two shards vs engine.run: " + "; ".join(problems[:5]))
    if per_shard != [2, 2] * J2_REPEATS:
        raise PhaseError(f"sharded: K1 launched {per_shard} times per shard, not twice in each")
    if contractions["two_shards"] != 4 * len(per_shard):
        raise PhaseError(f"sharded: the contraction launched {contractions['two_shards']} "
                         f"times in {len(per_shard)} shards, not 4 in each")
    if assembled["two_shards"] != len(per_shard):
        raise PhaseError(f"sharded: {assembled['two_shards']} assemble passes in "
                         f"{len(per_shard)} shards, not one in each")
    res["two_shards"] = {
        "n_loci": SHARDED_LOCI, "depth": 64, "resolution": 0.01,
        "devices": [str(d) for d in mesh.devices], "seconds": sharded_s,
        "loci_per_s": SHARDED_LOCI / min(sharded_s), "single_seconds": single_s,
        "single_loci_per_s": SHARDED_LOCI / min(single_s),
        "k1_launches_per_shard": per_shard[:2],
        "vs_single": {"max_rel": info["max_rel"], "af_max": info["af_max"],
                      "topk_swaps": len(info["topk_swaps"])},
    }

    # (j3) ranks over gloo on the one card: region halves of phase (c)
    whole = Path(cli_files["calls"]).read_text()
    n_c = len(vcf_record_keys(whole))
    half = n_c // SHARDED_RANKS
    if half * SHARDED_RANKS != n_c:
        raise PhaseError(f"sharded: {n_c} loci do not split into {SHARDED_RANKS} equal halves")
    t0 = time.perf_counter()
    shards = region_shards([cli_files["tumor"], cli_files["normal"]], work / "regions",
                           [half] * SHARDED_RANKS)
    split_s = time.perf_counter() - t0
    spec = {"loci": SHARDED_LOCI, "device": device, "obs": shards,
            "calls": [str(work / f"calls_rank{r}.vcf") for r in range(SHARDED_RANKS)],
            "kept": [str(work / f"kept_rank{r}.vcf") for r in range(SHARDED_RANKS)],
            "out": [str(work / f"engine_rank{r}.npz") for r in range(SHARDED_RANKS)]}
    t0 = time.perf_counter()
    reports = run_ranks(spec, work)
    ranks_s = time.perf_counter() - t0
    for rep in reports:
        if rep["jax_modules"] or rep["backend"] != "gloo":
            raise PhaseError(f"sharded: rank {rep['rank']}: {rep}")
        if rep["engine_k1_per_shard"] != [2] or rep["call_k1_launches"] == 0 \
                or rep["engine_contractions"] != 4 or rep["call_contractions"] == 0 \
                or rep["engine_assemble_passes"] != 1 \
                or rep["call_loci"] != half:
            raise PhaseError(f"sharded: rank {rep['rank']} launched K1 or the contraction {rep}")
    parts = [dict(np.load(p)) for p in spec["out"]]
    merged = {k: np.concatenate([part[k] for part in parts]) for k in parts[0]}
    problems, info = compare_outputs(single, merged)
    if problems:
        raise PhaseError("sharded: ranks' rows vs the single run: " + "; ".join(problems[:5]))
    texts = [Path(p).read_text() for p in spec["calls"]]
    joined = texts[0] + "".join(ln for t in texts[1:] for ln in t.splitlines(keepends=True)
                                if not ln.startswith("#"))
    problems, swapped = compare_vcf_text(whole, joined)
    if problems:
        raise PhaseError("sharded: ranks' calls vs phase (c): " + "; ".join(problems[:3]))
    kept = [k for p in spec["kept"] for k in vcf_record_keys(Path(p).read_text())]
    kept_c = vcf_record_keys(Path(cli_files["kept"]).read_text())
    if kept != kept_c or not kept:
        raise PhaseError(f"sharded: the ranks kept {len(kept)} records, control_fdr on "
                         f"phase (c)'s calls {len(kept_c)}")
    res["ranks"] = {"world_size": SHARDED_RANKS, "backend": "gloo", "split_s": split_s,
                    "seconds": ranks_s, "loci_per_rank": half, "reports": reports,
                    "engine_vs_single": {"max_rel": info["max_rel"], "af_max": info["af_max"]},
                    "calls_vs_single_topk_swapped_lines": len(swapped),
                    "kept": len(kept)}
    launches["ranks"] = sum(r["engine_k1_launches"] + r["call_k1_launches"] for r in reports)
    contractions["ranks"] = sum(r["engine_contractions"] + r["call_contractions"]
                                for r in reports)
    assembled["ranks"] = sum(r["engine_assemble_passes"] + r["call_assemble_passes"]
                             for r in reports)

    # (j4) NCCL, one rank
    res["nccl_one_rank"] = nccl_one_rank()
    res["k1_launches"] = launches
    res["contractions"] = contractions
    res["assemble_passes"] = assembled
    return res, sum(launches.values())


WAVEFRONT_SOURCE = "varlociraptor_tpu_torch/csrc/pairhmm_wavefront.cu"
# the XLA wavefronts the kernel replaces (no Pallas kernel): by flavour
WAVEFRONT_REPLACES = {"banded": "varlociraptor_tpu/ops/pairhmm.py:55",
                      "positional": "varlociraptor_tpu/ops/pairhmm.py:193",
                      "hop": "varlociraptor_tpu/ops/pairhmm.py:340"}
# phase (k1)'s timed shape: the main path's 128 x 128 panels of ~4,400
# items of 100-base reads (PERF.md §6, K2-K4's launches)
WAVEFRONT_MAIN_SHAPE = (4400, 128, 100)
# float32 operations per computed cell of the plain versions
# (ops/pairhmm_wavefront.py), each exp / log / log1p, add, sub, max and abs
# counted 1 (no FMA): lse2 6, lse3 12; banded M 23 (3 adds, lse3, lse2,
# the emission), D 8, I 15; positional adds t_mm (6) and t_dm (4) per
# cell; hop adds the HX / HY terms of M (14), HX (8) and HY (8)
WAVEFRONT_OPS_PER_CELL = {"banded": 46, "positional": 56, "hop": 76}
WAVEFRONT_FLAVOURS = ("banded", "positional", "hop")


def wavefront_sets():
    """(name, alleles, reads, quals, max_dists) of phase (k1): the main-path
    shape without a band and with the realigner's band (semiglobal edit
    distance + EDIT_BAND), the ragged _synth set, the edge sets of (a'),
    and reads over 1023 bases (two columns per thread)."""
    import numpy as np

    from varlociraptor_tpu_torch.bench_utils import (
        pairhmm_edge_items,
        pairhmm_items,
        pairhmm_shape_items,
        semiglobal_distances,
    )
    from varlociraptor_tpu_torch.evidence.edit_distance import EDIT_BAND

    def banded(items):
        return [int(d) + EDIT_BAND for d in semiglobal_distances(items[0], items[1])]

    main = pairhmm_shape_items(*WAVEFRONT_MAIN_SHAPE, seed=7)
    synth = pairhmm_items(21, 3)
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    long_a = [bytes(acgt[rng.integers(0, 4, n)].tobytes()) for n in (1300, 1100)]
    long_r = [np.frombuffer(long_a[0][100:1200], np.uint8),
              np.frombuffer(long_a[1][500:600], np.uint8)]
    long_items = (long_a, long_r, [np.full(len(r), 30, np.uint8) for r in long_r])
    sets = [("main", *main, None), ("main_banded", *main, banded(main)),
            ("synth_ragged", *synth, None), ("synth_ragged_banded", *synth, banded(synth)),
            ("long_read", *long_items, banded(long_items))]
    sets += [(name, *items, None) for name, items in pairhmm_edge_items().items()
             if name != "long_allele"]
    return sets


def wavefront_case(flavour, name, args, timer):
    """The wavefront kernel against its plain version on the same device
    tensors: -1e30 items alike, the rest within K23_TOL x max(1, |x|) above
    FORWARD_FLOOR; the main-path sets timed with their bound."""
    import numpy as np
    import torch

    from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf

    fn = pwf.WRAPPERS[flavour]
    g = fn(*args).cpu().numpy()
    torch.cuda.synchronize()
    stats = {"cells": 0}
    p = pwf.reference_of(flavour, args, stats).cpu().numpy()
    if not np.array_equal(g <= -1e30, p <= -1e30) or not np.isfinite(g).all():
        raise PhaseError(f"wavefront {flavour} {name}: -1e30 items differ from the plain "
                         "version, or a result is not finite")
    live = p > -1e30
    deep = live & (g < FORWARD_FLOOR) & (p < FORWARD_FLOOR)
    held = live & ~deep
    err = np.abs(g[held] - p[held])
    rel = float(np.max(err / np.maximum(1.0, np.abs(p[held])))) if held.any() else 0.0
    if not rel <= K23_TOL:
        raise PhaseError(f"wavefront {flavour} {name}: rel err {rel} > {K23_TOL}")
    B, Xp = args[0].shape
    Yp = args[2].shape[1]
    case = {"kernel": flavour, "case": name, "B": B, "Xp": Xp, "Yp": Yp,
            "cols_per_thread": pwf.cols_per_thread(Yp), "impossible": int((~live).sum()),
            "below_floor": int(deep.sum()), "max_abs_err": float(err.max()) if held.any()
            else 0.0, "max_rel_err": rel, "cells_computed": stats["cells"],
            "cells_full": int((args[1].double() * args[4].double()).sum().item())}
    if name.startswith("main"):
        case["ms"] = timer(lambda: fn(*args), 10, ahead=True)
        case["plain_ms"] = timer(lambda: pwf.reference_of(flavour, args), 1,
                                 warmup=0)  # ran just above
        case["gcells_per_s"] = stats["cells"] / case["ms"] / 1e6
        case.update(roofline(WAVEFRONT_OPS_PER_CELL[flavour] * stats["cells"],
                             sum(t.numel() * t.element_size() for t in args) + 4 * B))
    return case


def phase_wavefront_vs_plain(timer=cuda_ms):
    """(k1): the wavefront kernel of every flavour against its plain
    version on the card, with the ONT-like gaps of (a'') and its hop rates
    (ln 0.05), without and with the realigner's bands."""
    from varlociraptor_tpu_torch.estimation.alignment_properties import HopParams
    from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf

    hop = HopParams(*([[HOP_LN] * 4] * 4))
    out = {"phase": "wavefront_vs_plain", "tol_rel": K23_TOL, "floor": FORWARD_FLOOR,
           "gap": GAP_ONT, "hop_ln": HOP_LN, "cases": []}
    worst = dict.fromkeys(WAVEFRONT_FLAVOURS, 0.0)
    timed = {f: {} for f in WAVEFRONT_FLAVOURS}
    for name, alleles, reads, quals, dists in wavefront_sets():
        for flavour in WAVEFRONT_FLAVOURS:
            _, args = pwf.wavefront_args(
                alleles, reads, quals, dists, GAP_ONT, "cuda",
                hop=None if flavour == "banded" else hop, hop_states=flavour == "hop")
            case = wavefront_case(flavour, name, args, timer)
            worst[flavour] = max(worst[flavour], case["max_abs_err"])
            if "ms" in case:
                timed[flavour][name] = case
            out["cases"].append(case)
    out["max_abs_err"] = worst
    return out, timed


# phase (k2)-(k4)'s regions: the head of phase (e)'s and phase (d)'s
# candidates that the plain CPU wavefronts take in ~15-30 s
HOP_REGION_LOCI = 24
BANDED_REGION_LOCI = 36


@contextlib.contextmanager
def env_vars(**values):
    """Set the VLT_* switches inside the block (None unsets), then restore."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def region_head(candidates, n):
    """The region (CHROM:1-POS) that holds the first n candidate records of
    the first contig."""
    recs = [line.split("\t", 2)[:2] for line in Path(candidates).read_text().splitlines()
            if line and not line.startswith("#")]
    chrom = recs[0][0]
    pos = [int(p) for c, p in recs if c == chrom][: n]
    return f"{chrom}:1-{pos[-1]}"


def wavefront_counts():
    from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf

    return {f: pwf.WRAPPERS[f].launches for f in WAVEFRONT_FLAVOURS}


def reset_wavefront_counts():
    from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf

    for f in WAVEFRONT_FLAVOURS:
        pwf.WRAPPERS[f].launches = 0


def region_run(world, props, region, out, device, flags=(), **switches):
    """``preprocess variants --region`` of the tumor with the VLT_* switches
    given; returns (seconds, wavefront launches, column-kernel launches)."""
    reset_wavefront_counts()
    reset_pairhmm_counts()
    with env_vars(**switches):
        t0 = time.perf_counter()
        rc = cli_quiet(["preprocess", "variants", world["fasta"], "--bam", world["tumor"],
                        "--candidates", world["candidates"], "--output", str(out),
                        "--sample-name", "tumor", "--alignment-properties", str(props),
                        "--region", region, "--device", device, *flags])
        secs = time.perf_counter() - t0
    if rc != 0:
        raise PhaseError(f"wavefront_routes: preprocess {switches} on {device} returned {rc}")
    return secs, wavefront_counts(), pairhmm_counts()


def held_to(ref, got, what, ties=False):
    """compare.py's observation check (the -30 floor) of two files; with
    ``ties``, reads whose prob_alt equals prob_ref left out of both."""
    from varlociraptor_tpu_torch.compare import compare_observation_files

    problems, info = compare_observation_files(ref, got, ties=ties)
    if problems:
        raise PhaseError(f"wavefront_routes: {what}: " + "; ".join(problems[:3]))
    return info


def phase_wavefront_routes(work, serial, serial_hp, device="cuda"):
    """(k2)-(k4): the pair-HMM routes the JAX package takes off its default,
    through the CLI on the card: (k2) the hop-state model (VLT_HOP_STATES=1,
    homopolymer mode) on a region of phase (e)'s world, on the card (the hop
    wavefront kernel) and on the CPU (its plain version); (k3) the banded
    wavefront (VLT_PALLAS_PAIRHMM=0) on a region of phase (d)'s world, card
    against CPU, and its positional flavour on (k2)'s region; (k4) the
    native host forward (VLT_NATIVE_PAIRHMM=1) on both regions, which
    launches no pair-HMM kernel, against (k3)'s files."""
    from varlociraptor_tpu_torch.io import native

    res = {"phase": "wavefront_routes", "native_host_library": native.available()}
    wf_launches = dict.fromkeys(WAVEFRONT_FLAVOURS, 0)
    by_part = {}
    hp_w, pp_w = serial_hp["world"], serial["world"]
    hp_region = region_head(hp_w["candidates"], HOP_REGION_LOCI)
    pp_region = region_head(pp_w["candidates"], BANDED_REGION_LOCI)
    hp_flags = ("--pairhmm-mode", "homopolymer")
    runs = {}

    def run(name, world, props, region, dev, flags=(), **switches):
        out = work / f"{name}.{dev}.obs"
        secs, wf, col = region_run(world, props, region, out, dev, flags, **switches)
        from varlociraptor_tpu_torch.calling.observations import ObservationReader

        n = len(ObservationReader(str(out)).read_window(1 << 20)[0])
        runs[f"{name}_{dev}"] = {"region": region, "records": n, "seconds": secs,
                                 "loci_per_s": n / secs, "wavefront_launches": wf,
                                 "column_launches": col}
        if dev != "cpu":  # the plain versions on the CPU count nothing
            for f in WAVEFRONT_FLAVOURS:
                wf_launches[f] += wf[f]
            by_part[name] = {f: v for f, v in wf.items() if v}
        return out, wf, col

    no_native = {"VLT_NATIVE_PAIRHMM": None}
    # (k2) hop-state model: card against CPU
    hop_sw = {"VLT_HOP_STATES": "1", "VLT_PALLAS_PAIRHMM": None, **no_native}
    g, wf, col = run("hop_states", hp_w, serial_hp["props"], hp_region, device, hp_flags,
                     **hop_sw)
    if not wf["hop"] or wf["banded"] or wf["positional"] or any(col.values()):
        raise PhaseError(f"hop_states: the hop wavefront must launch alone: {wf}, {col}")
    c, _, _ = run("hop_states", hp_w, serial_hp["props"], hp_region, "cpu", hp_flags,
                  **hop_sw)
    res["hop_states_cuda_vs_cpu"] = held_to(c, g, "hop_states cuda vs cpu")
    # (k3) VLT_PALLAS_PAIRHMM=0: the banded wavefront, card against CPU, and
    # its positional flavour in homopolymer mode
    off_sw = {"VLT_HOP_STATES": "0", "VLT_PALLAS_PAIRHMM": "0", **no_native}
    banded, wf, col = run("pallas_off", pp_w, serial["props"], pp_region, device, **off_sw)
    if not wf["banded"] or wf["hop"] or wf["positional"] or any(col.values()):
        raise PhaseError(f"pallas_off: the banded wavefront must launch alone: {wf}, {col}")
    c, _, _ = run("pallas_off", pp_w, serial["props"], pp_region, "cpu", **off_sw)
    res["pallas_off_cuda_vs_cpu"] = held_to(c, banded, "pallas_off cuda vs cpu")
    positional, wf, col = run("pallas_off_homopolymer", hp_w, serial_hp["props"], hp_region,
                              device, hp_flags, **off_sw)
    if not wf["positional"] or wf["hop"] or wf["banded"] or any(col.values()):
        raise PhaseError(f"pallas_off_homopolymer: the positional wavefront must launch "
                         f"alone: {wf}, {col}")
    # (k4) the native host forward: no pair-HMM kernel, (k3)'s files
    nat_sw = {"VLT_HOP_STATES": "0", "VLT_PALLAS_PAIRHMM": None, "VLT_NATIVE_PAIRHMM": "1"}
    for name, world, props, region, flags, ref in (
            ("native", pp_w, serial["props"], pp_region, (), banded),
            ("native_homopolymer", hp_w, serial_hp["props"], hp_region, hp_flags, positional)):
        got, wf, col = run(name, world, props, region, device, flags, **nat_sw)
        if any(wf.values()) or any(col.values()):
            raise PhaseError(f"{name}: a pair-HMM kernel launched: {wf}, {col}")
        # a read whose alleles tie is kept by one route and not the other,
        # in the JAX package alike (ROADMAP C)
        res[f"{name}_vs_wavefront"] = held_to(ref, got, f"{name} vs the wavefront",
                                              ties=True)
    res["runs"] = runs
    res["wavefront_launches"] = wf_launches
    res["wavefront_launches_by_part"] = by_part
    return res, wf_launches, by_part


def main():
    import os

    sys.meta_path.insert(0, refuse_jax)
    # the same block in every Python process this one starts (phase (g)'s
    # spawned preprocess workers): an import hook is not inherited
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / NO_JAX_GUARD), os.environ.get("PYTHONPATH")) if p)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from varlociraptor_tpu_torch import _build
        from varlociraptor_tpu_torch.bench_utils import tumor_normal_engine
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # phases (d)'s and (e)'s worlds, simulated on the host while (a)-(c) run
    import atexit

    atexit.register(stop_world_jobs)
    pp_world = WorldJob(work / "world", **PREPROCESS_WORLD)
    hp_world = WorldJob(work / "homopolymer" / "world", **PREPROCESS_WORLD, homopolymer=True)

    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": str(_build.library_path().relative_to(ROOT))})

    _, engine = tumor_normal_engine(resolution=0.01, purity=0.75, device="cuda")
    a, bench = phase_kernel_vs_plain(engine)
    emit(a)
    a2, hmm_bench, hmm_main = phase_pairhmm_vs_plain()
    emit(a2)
    a3, k4_bench, k4_main = phase_positional_vs_plain()
    emit(a3)
    a4, lc_bench = phase_contraction_vs_plain()
    emit(a4)
    a5, lfs_bench = phase_lfc_star_vs_plain()
    emit(a5)
    a6, as_bench = phase_assemble_vs_plain()
    emit(a6)
    b = phase_engine(engine)
    emit(b)
    c, launches = phase_cli(work)
    emit(c)
    d, hmm_launches, serial = phase_preprocess(work, pp_world)
    emit(d)
    e, hp_launches, serial_hp = phase_homopolymer(work / "homopolymer", hp_world)
    emit(e)
    (work / "engine_modes").mkdir()
    f, mode_launches = phase_engine_modes(work / "engine_modes")
    emit(f)
    g, thread_launches = phase_preprocess_threads(work, serial, serial_hp)
    emit(g)
    cli_files = {"tumor": str(work / "obs" / "tumor.obs"),
                 "normal": str(work / "obs" / "normal.obs"), "calls": str(work / "calls.vcf")}
    pp_files = {"tumor": str(work / "tumor.obs"), "normal": str(work / "normal.obs"),
                "calls": str(work / "pp_calls.vcf")}
    h, legacy_launches, k1_legacy = phase_legacy_and_estimates(
        work, cli_files, pp_files, serial["world"]["truth"])
    emit(h)
    (work / "kinds").mkdir()
    i, kinds_launches, kinds_worst = phase_kinds_and_testcases(work / "kinds")
    emit(i)
    (work / "sharded").mkdir()
    j, sharded_launches = phase_sharded(
        work / "sharded", engine, {**cli_files, "kept": str(work / "somatic.fdr.vcf")})
    emit(j)
    k1_phase, wf_timed = phase_wavefront_vs_plain()
    emit(k1_phase)
    (work / "wavefront").mkdir()
    k, wf_launches, wf_by_part = phase_wavefront_routes(
        work / "wavefront", serial, serial_hp)
    emit(k)
    by_phase = {kind: {"preprocess": hmm_launches[kind], "homopolymer": hp_launches[kind],
                       "preprocess_threads": thread_launches[kind],
                       "kinds_and_testcases": kinds_launches[kind]}
                for kind in PAIRHMM_KINDS}
    repo_attempts = []
    for name, stack in refuse_jax.attempts:
        print(f"chip_smoke: refused an import of {name} from:\n{stack}", file=sys.stderr)
        if str(ROOT) in stack.replace(__file__, ""):
            repo_attempts.append(name)
    if repo_attempts or any(m.split(".")[0] in REFUSED for m in sys.modules):
        raise PhaseError(f"the port tried to import {repo_attempts or 'jax'}")
    # no single PyTorch call computes any of the four functions
    timing = lambda case: {k: case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}  # noqa: E731
    main_shape = lambda case: {"main_path_shape": {  # noqa: E731
        **{k: case[k] for k in ("B", "Xp", "Yp", "tile")}, **timing(case)}}
    lc_by_phase = {"cli": c["contractions"], "engine_modes": f["contractions"],
                   "sharded": j["contractions"]}
    # the assemble head and tail launch once each a pass: the checked cases
    # of (a''''') (not its timing loops) and the main path's passes
    as_by_phase = {"assemble_vs_plain": len(a6["cases"]),
                   "engine": b["assemble_passes_per_call"] * len(b["seconds"]),
                   "cli": c["assemble_passes"],
                   "engine_modes": {**{m["mode"]: m["assemble_passes_per_call"] * 3
                                       for m in f["modes"]},
                                    "cli": f["cli"]["assemble_passes"]},
                   "sharded": j["assemble_passes"]}
    emit({"kernels": [{
        "name": "ll_classes", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": (launches + mode_launches + legacy_launches + kinds_launches["ll_classes"]
                     + sharded_launches),
        "launches_by_phase": {"cli": launches, "engine_modes": mode_launches,
                              "legacy_and_estimates": legacy_launches,
                              "kinds_and_testcases": kinds_launches["ll_classes"],
                              "sharded": sharded_launches},
        "max_abs_err": max([a["max_abs_err"]] + [c["max_abs_err"] for c in k1_legacy]),
        **timing(bench), "library_ms": None,
    }] + [{
        "name": f"pairhmm_{kind}", "route": "cuda", "source": K23_SOURCE,
        "replaces": replaces, "launches": sum(by_phase[kind].values()),
        "launches_by_phase": by_phase[kind],
        "max_abs_err": max(a2["max_abs_err"][kind], kinds_worst[kind]), **timing(hmm_bench[kind]),
        "library_ms": None, **main_shape(hmm_main[kind]),
    } for kind, replaces in (("exact", K2_REPLACES), ("general", K3_REPLACES))] + [{
        "name": "pairhmm_positional", "route": "cuda", "source": K23_SOURCE,
        "replaces": K4_REPLACES, "launches": sum(by_phase["positional"].values()),
        "launches_by_phase": by_phase["positional"],
        "max_abs_err": a3["max_abs_err"], **timing(k4_bench), "library_ms": None,
        **main_shape(k4_main),
    }] + [{
        "name": f"pairhmm_wavefront_{flavour}", "route": "cuda", "source": WAVEFRONT_SOURCE,
        "replaces": WAVEFRONT_REPLACES[flavour], "launches": wf_launches[flavour],
        "launches_by_phase": {"wavefront_routes": {
            part: n[flavour] for part, n in wf_by_part.items() if flavour in n}},
        "max_abs_err": k1_phase["max_abs_err"][flavour],
        **timing(wf_timed[flavour]["main"]), "library_ms": None,
        "shape": [wf_timed[flavour]["main"][k] for k in ("B", "Xp", "Yp")],
        "banded": timing(wf_timed[flavour]["main_banded"]),
    } for flavour in WAVEFRONT_FLAVOURS] + [{
        "name": "lse_contract", "route": "cuda", "source": LC_SOURCE, "replaces": LC_REPLACES,
        "launches": sum(n if isinstance(n, int) else sum(n.values())
                        for n in lc_by_phase.values()),
        "launches_by_phase": lc_by_phase, "max_abs_err": a4["max_abs_err"],
        **timing(lc_bench), "library_ms": None, "shape": lc_bench["F"],
        "window": a4["window"],
    }] + [{
        "name": "lfc_star", "route": "cuda", "source": LFS_SOURCE, "replaces": LFS_REPLACES,
        "launches": len(a5["cases"]) + sum(m["lfc_star_launches_per_call"] * 3
                                           for m in f["modes"]),
        "launches_by_phase": {"lfc_star_vs_plain": len(a5["cases"]),
                              "engine_modes": {m["mode"]: m["lfc_star_launches_per_call"] * 3
                                               for m in f["modes"]}},
        "max_abs_err": a5["max_abs_err"], **timing(lfs_bench), "library_ms": None,
        "shape": lfs_bench["shape"],
    }] + [{
        "name": f"assemble_{part}", "route": "cuda", "source": AS_SOURCE,
        "replaces": AS_REPLACES,
        "launches": sum(n if isinstance(n, int) else sum(n.values())
                        for n in as_by_phase.values()),
        "launches_by_phase": as_by_phase, "max_abs_err": a6["max_abs_err"], **as_bench[part], "library_ms": None,
        "shape": {k: as_bench[k] for k in ("L", "B", "NB", "E", "G")},
    } for part in ("head", "tail")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


refuse_jax = _RefuseJax()

if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
