#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``varlociraptor_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``varlociraptor_tpu_torch/csrc``
with nvcc (sm_90a, one process per source), then runs nine phases, each
printing one JSON line.  It refuses every import of ``jax``, ``jaxlib`` and
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
  (b) engine           the tumor-normal engine (resolution 0.01) on 32768
                       synthetic loci at depth 64, every output copied to the
                       host; K1 must launch twice per call; the first 1024 loci
                       are re-run with the plain version on the card and every
                       output compared.
  (c) cli              100,000 synthetic tumor/normal loci through
                       ``call variants tumor-normal --device cuda`` and
                       ``filter-calls control-fdr``; the first 2,000 loci are
                       re-called with ``--device cpu`` and the VCFs compared.
  (d) preprocess       a 2 Mb tumor/normal world (30x, 2x100 bp, 1,500 planted
                       indels and 500 decoys) through ``estimate
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
                       mendelian trio at 0.01: 101^3 cells).
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

The line before the last lists the kernels ({"kernels": [...]}): K1 with the
launches counted in phases (c) and (f), K2-K4 with those counted in phase
(d)'s preprocess steps, phase (e)'s and phase (g)'s workers (each also by
phase, ``launches_by_phase``); each with its time, its
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


def phase_engine(engine, L=32768, n_plain=1024):
    import numpy as np
    import torch

    from varlociraptor_tpu_torch.bench_utils import engine_inputs
    from varlociraptor_tpu_torch.compare import compare_outputs
    from varlociraptor_tpu_torch.ops import ll_classes as k1

    inputs = engine_inputs(engine, n_loci=L, depth=64, seed=0)
    engine.run(*inputs)  # warm-up: first launches, allocator growth
    n0 = k1.ll_classes.launches
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = engine.run(*inputs)  # every output lands on the host
        times.append(time.perf_counter() - t0)
    launches = k1.ll_classes.launches - n0
    if launches != 2 * len(times):
        raise PhaseError(f"engine: K1 launched {launches} times in {len(times)} calls")
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

    t0 = time.perf_counter()
    tumor, normal, truth = synth_observation_files(work / "obs", n_loci=n_loci, seed=0)
    synth_s = time.perf_counter() - t0
    calls = work / "calls.vcf"
    k1.ll_classes.launches = 0  # main path starts here
    t0 = time.perf_counter()
    rc = cli.run(["call", "variants", "tumor-normal", "--tumor", tumor,
                  "--normal", normal, "--purity", "0.75", "--device", device,
                  "--output", str(calls)])
    call_s = time.perf_counter() - t0
    launches = k1.ll_classes.launches
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
    if len(kept_pos) == 0 or launches == 0:
        raise PhaseError(f"cli: kept {len(kept_pos)}, K1 launches {launches}")

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
    lines = calls_text.splitlines(keepends=True)
    n_head = sum(1 for ln in lines if ln.startswith("#"))
    gpu_head = "".join(lines[: n_head + n_cpu])
    problems, swapped = compare_vcf_text(calls_cpu.read_text(), gpu_head)
    if rc != 0 or problems:
        raise PhaseError("cli cuda vs cpu VCF: " + "; ".join(problems[:3]))
    return {
        "phase": "cli", "n_loci": n_loci, "records": n_called,
        "somatic_kept": int(len(kept_pos)),
        "planted_somatic": int(len(truth["somatic"])),
        "planted_somatic_recall": recall,
        "synth_s": synth_s, "call_s": call_s, "call_loci_per_s": n_loci / call_s,
        "fdr_s": fdr_s, "k1_launches": launches,
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


def phase_preprocess(work, genome_len=2_000_000, n_germline=1000, n_somatic=500,
                     n_decoy=500, n_rerun=200, n_cpu=192, device="cuda"):
    import json as _json

    import numpy as np

    from varlociraptor_tpu_torch.estimation.alignment_properties import (
        AlignmentProperties,
        GapParams,
    )
    from varlociraptor_tpu_torch.io import native
    from varlociraptor_tpu_torch.bench_utils import synth_preprocess_world

    res = {"phase": "preprocess", "native_host_library": native.available()}
    secs = res["seconds"] = {}
    t0 = time.perf_counter()
    w = synth_preprocess_world(work / "world", seed=0, genome_len=genome_len,
                               n_germline=n_germline, n_somatic=n_somatic,
                               n_decoy=n_decoy)
    secs["world"] = time.perf_counter() - t0
    n = w["n_candidates"]
    res.update(genome_len=genome_len, candidates=n, reads=w["reads"])

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


def phase_homopolymer(work, genome_len=2_000_000, n_germline=1000, n_somatic=500,
                      n_decoy=500, n_cpu=192, device="cuda"):
    """(e): phase (d)'s pipeline on the homopolymer world, in the
    homopolymer pair-HMM mode (K4 with the estimated hop params)."""
    import json as _json

    import numpy as np

    from varlociraptor_tpu_torch.bench_utils import synth_preprocess_world

    res = {"phase": "homopolymer"}
    secs = res["seconds"] = {}
    t0 = time.perf_counter()
    w = synth_preprocess_world(work / "world", seed=0, genome_len=genome_len,
                               n_germline=n_germline, n_somatic=n_somatic,
                               n_decoy=n_decoy, homopolymer=True)
    secs["world"] = time.perf_counter() - t0
    n = w["n_candidates"]
    res.update(genome_len=genome_len, candidates=n, reads=w["reads"],
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
    from varlociraptor_tpu_torch.ops import ll_classes as k1

    inputs = engine_inputs(engine, n_loci=n_loci, depth=64, seed=0)
    pj = None
    if table is not None:
        pj = np.ascontiguousarray(np.broadcast_to(table, (n_loci,) + table.shape))
    engine.run(*inputs, ln_prior_joint=pj)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.ll_classes.launches = 0  # main path starts here
    engine.loop_steps = 0
    ms, wall, runs = [], [], 3
    with k1_shapes() as shapes:
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = engine.run(*inputs, ln_prior_joint=pj)  # outputs on the host
            end.record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            ms.append(start.elapsed_time(end))
    launches = k1.ll_classes.launches
    steps = engine.loop_steps
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or launches != sum(shapes.values()) or launches % runs:
        raise PhaseError(f"engine_modes {name}: K1 launched {launches} times in {runs} calls")
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
        plain = engine.run(*sub, ln_prior_joint=None if pj is None else pj[:MODES_PLAIN])
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
        "vs_plain_head": {"n_loci": min(MODES_PLAIN, n_loci), "seconds": plain_s,
                          "max_rel": info["max_rel"], "af_max": info["af_max"],
                          "af_flat": len(info["af_flat"]),
                          "topk_swaps": len(info["topk_swaps"])},
    }, launches


def prior_table_seconds():
    """Host seconds of the --full-prior table of the mendelian trio with
    every sample at resolution 0.01 (101^3 cells, prior.compute once per
    cell)."""
    import copy

    import numpy as np

    from varlociraptor_tpu_torch.bench_utils import TRIO_SCENARIO, full_prior_table, scenario_engine

    doc = copy.deepcopy(TRIO_SCENARIO)
    for sample in doc["samples"].values():
        sample["resolution"] = 0.01
    scenario, trio = scenario_engine(doc, 0.01, device="cuda")
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

    res = {"phase": "engine_modes", "depth": 64, "resolution": 0.01, "modes": []}
    launches = 0
    scenario, tn = bu.tumor_normal_engine(resolution=0.01, purity=0.75, device="cuda")
    table, table_s = bu.full_prior_table(scenario, tn)
    res["prior_table_tumor_normal"] = {"cells": int(table.size), "shape": list(table.shape),
                                       "host_s": table_s}
    for name, build, tbl in (
        ("full_prior", lambda: tn, table),
        ("l2fc", lambda: bu.l2fc_engine(device="cuda"), None),
        ("cyclic", lambda: bu.cyclic_engine(device="cuda"), None),
    ):
        rec, n = mode_run(name, build(), MODE_LOCI[name], tbl)
        res["modes"].append(rec)
        launches += n

    # the CLI: tumor-normal with --full-prior, then its head on the CPU
    tumor, normal, _ = bu.synth_observation_files(work / "fp_obs", n_loci=MODES_CLI_LOCI, seed=1)
    yaml_path = work / "tumor_normal.yaml"
    yaml_path.write_text(json.dumps(scenario.doc))  # JSON is YAML
    calls = work / "fp_calls.vcf"
    argv = ["call", "variants", "generic", "--scenario", str(yaml_path), "--obs",
            f"tumor={tumor}", f"normal={normal}", "--full-prior"]
    k1.ll_classes.launches = 0  # main path starts here
    t0 = time.perf_counter()
    rc = cli.run(argv + ["--device", "cuda", "--output", str(calls)])
    call_s = time.perf_counter() - t0
    cli_launches = k1.ll_classes.launches
    calls_text = calls.read_text()
    n_called = len(vcf_record_keys(calls_text))
    if rc != 0 or n_called != MODES_CLI_LOCI or cli_launches == 0:
        raise PhaseError(f"engine_modes cli: rc {rc}, {n_called} records, "
                         f"{cli_launches} K1 launches")
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
    lines = calls_text.splitlines(keepends=True)
    n_head = sum(1 for ln in lines if ln.startswith("#"))
    problems, swapped = compare_vcf_text(calls_cpu.read_text(), "".join(lines[: n_head + MODES_CLI_CPU]))
    if rc != 0 or problems:
        raise PhaseError("engine_modes cli cuda vs cpu VCF: " + "; ".join(problems[:3]))
    windows = -(-MODES_CLI_LOCI // 1024)
    res["cli"] = {
        "n_loci": MODES_CLI_LOCI, "records": n_called, "call_s": call_s,
        "call_loci_per_s": MODES_CLI_LOCI / call_s, "k1_launches": cli_launches,
        "k1_launches_per_window": cli_launches / windows,
        "cpu_2k_call_s": cpu_s, "cpu_vs_cuda_topk_swapped_lines": swapped,
    }
    res["prior_table_trio"] = prior_table_seconds()
    res["k1_launches"] = launches
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
    emit(phase_engine(engine))
    c, launches = phase_cli(work)
    emit(c)
    d, hmm_launches, serial = phase_preprocess(work)
    emit(d)
    (work / "homopolymer").mkdir()
    e, hp_launches, serial_hp = phase_homopolymer(work / "homopolymer")
    emit(e)
    (work / "engine_modes").mkdir()
    f, mode_launches = phase_engine_modes(work / "engine_modes")
    emit(f)
    g, thread_launches = phase_preprocess_threads(work, serial, serial_hp)
    emit(g)
    by_phase = {kind: {"preprocess": hmm_launches[kind], "homopolymer": hp_launches[kind],
                       "preprocess_threads": thread_launches[kind]}
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
    emit({"kernels": [{
        "name": "ll_classes", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches + mode_launches,
        "launches_by_phase": {"cli": launches, "engine_modes": mode_launches},
        "max_abs_err": a["max_abs_err"], **timing(bench), "library_ms": None,
    }] + [{
        "name": f"pairhmm_{kind}", "route": "cuda", "source": K23_SOURCE,
        "replaces": replaces, "launches": sum(by_phase[kind].values()),
        "launches_by_phase": by_phase[kind], "max_abs_err": a2["max_abs_err"][kind], **timing(hmm_bench[kind]),
        "library_ms": None, **main_shape(hmm_main[kind]),
    } for kind, replaces in (("exact", K2_REPLACES), ("general", K3_REPLACES))] + [{
        "name": "pairhmm_positional", "route": "cuda", "source": K23_SOURCE,
        "replaces": K4_REPLACES, "launches": sum(by_phase["positional"].values()),
        "launches_by_phase": by_phase["positional"],
        "max_abs_err": a3["max_abs_err"], **timing(k4_bench), "library_ms": None,
        **main_shape(k4_main),
    }]})
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
