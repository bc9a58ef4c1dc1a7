"""K3 tile variants, and earlier pair-HMM libraries, timed against each other on one card.

    python scripts/torch_k3_variants.py [--old OLD.cu ...]
        [--variants new new:r8 new:l32 OLD ...] [--real LAUNCHES.pt]
        [--rounds 5] [--out DIR]

Builds ``varlociraptor_tpu_torch/csrc/pairhmm_column.cu`` ("new") and each
``--old`` source (an earlier ``pairhmm_column.cu``, e.g. ``git show
<commit>:varlociraptor_tpu_torch/csrc/pairhmm_column.cu``, named by its file
stem) with ``-Xptxas -v``, one nvcc per source, all at once.  A variant is a
library and, for a library whose K3 entry takes a tile, a tile policy:
``:rN`` caps the rows per lane at N, ``:lN`` fixes N lanes per item, and the
tile is then the one ``ops/pairhmm_column.general_tile`` picks under those
limits (no suffix: its default).  Each variant's K3 is held to the plain
version on every set of ``chip_smoke.py`` phase (a') (1e-4 x max(1, |x|),
the same finiteness and -1e30 items), then all variants are timed with CUDA
events in rounds that rotate their order, at the three timed shapes of
phase (a') (4096 x 160 x 100, 16384 x 256 x 150 and the main-path shape
``chip_smoke.K3_MAIN_SHAPE``) and, with ``--real``, on the main-path K3
launches that ``chip_smoke.py`` phase (d) saved (each held to the plain
version too, timed as one run of all of them).  K2 and K4 of every library
are timed beside them at the three shapes.  Prints the card's name and power limit, one JSON
line per library (registers and spills of each kernel, K2 / K4 median ms)
and per variant (tiles, errors, K3 median ms), and writes all of it to
DIR/k3_variants.json.  Needs a CUDA device and nvcc; exits non-zero
without them or when a variant disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from varlociraptor_tpu_torch._build import ARCH_FLAGS, CSRC, _nvcc  # noqa: E402
from varlociraptor_tpu_torch.ops import pairhmm_column as phc  # noqa: E402

TOL = chip_smoke.K23_TOL
SHAPES = ("b4096_x160_y100", chip_smoke.BENCH_SET, chip_smoke.MAIN_SET)


def _compile(jobs, out_dir):
    """{name: (library path, {kernel: registers / spills})}; jobs {name: source}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _nvcc(), {}
    for name, src in jobs.items():
        lib = out_dir / f"lib_{name}.so"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", str(src), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernels, current = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                current = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and current:
                kernels.setdefault(current, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and current:
                kernels.setdefault(current, {})["spill_store_bytes"] = int(m.group(1))
        built[name] = (lib, kernels)
    return built


class Library:
    """A pair-HMM library's three C entries, bound with ctypes."""

    def __init__(self, path, tiled):
        self.lib = ctypes.CDLL(str(path))
        self.tiled = tiled
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.vlt_pairhmm_exact.argtypes = [p] * 7 + [i] * 3 + [p]
        self.lib.vlt_pairhmm_general.argtypes = [p] * 7 + [i] * (5 if tiled else 3) + [p]
        self.lib.vlt_pairhmm_positional.argtypes = [p] * 10 + [i] * 3 + [p]

    def __call__(self, fn_name, allele, read, *tensors, tile=()):
        B, Xp = allele.shape
        out = torch.empty(B, dtype=torch.float32, device=allele.device)
        err = getattr(self.lib, fn_name)(
            *[t.data_ptr() for t in (allele, read, *tensors, out)], B, Xp, read.shape[1],
            *tile, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{fn_name}: CUDA error {err}")
        return out


def _tile(spec, Xp):
    """The tile of a variant spec's policy at panel width Xp (None: the
    library picks its own)."""
    if spec is None:
        return None
    limits = {"r": None, "l": None}
    for part in spec:
        limits[part[0]] = int(part[1:])
    return phc.general_tile(Xp, max_rows=limits["r"], lanes=limits["l"])


def _rel_err(got, ref):
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    if not (np.array_equal(np.isfinite(g), np.isfinite(r))
            and np.array_equal(g <= -1e30, r <= -1e30)):
        return None
    live = r > -1e30
    if not live.any():
        return 0.0
    return float(np.max(np.abs(g[live] - r[live]) / np.maximum(1.0, np.abs(r[live]))))


def _ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", nargs="*", default=[], help="earlier pairhmm_column.cu sources")
    ap.add_argument("--variants", nargs="*", default=["new"],
                    help="LIB[:rN][:lN]: a library (new, or an --old stem) and a tile policy")
    ap.add_argument("--real", help="K3 launches saved by chip_smoke.py phase (d) "
                                   f"(build/chip_smoke/{chip_smoke.K3_LAUNCHES_FILE})")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "build" / "k3_variants"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = Path(args.out)
    jobs = {"new": CSRC / "pairhmm_column.cu"}
    jobs.update({Path(p).stem: Path(p) for p in args.old})
    built = _compile(jobs, out_dir / "libs")
    tiled = {name: re.search(r"vlt_pairhmm_general\([^)]*int lanes", src.read_text()) is not None
             for name, src in jobs.items()}
    libs = {name: Library(lib, tiled[name]) for name, (lib, _) in built.items()}
    variants = {}
    for v in args.variants:
        lib, *spec = v.split(":")
        variants[v] = (lib, spec if tiled[lib] else None)

    from varlociraptor_tpu_torch.estimation.alignment_properties import HopParams

    hop = HopParams(*([[chip_smoke.HOP_LN] * 4] * 4))
    report = {"libraries": {name: {"kernels": info, "ms": {}} for name, (_, info) in built.items()},
              "variants": {v: {"tiles": {}, "max_rel_err": {}, "ms": {}} for v in variants}}
    k3_sets = []  # (name, K3 device inputs)
    timed, others = {}, {}  # K3 launches, and K2 / K4 inputs, per timed shape
    for name, alleles, reads, quals in chip_smoke.pairhmm_sets():
        packed, _, _, _ = phc.pack_exact_batch(alleles, reads, quals, chip_smoke.GAP_ONT)
        dev = phc.to_device(packed[:5] + (phc.general_coef(chip_smoke.GAP_ONT),), "cuda")
        k3_sets.append((name, dev))
        if name in SHAPES:
            zero = phc.to_device(phc.pack_exact_batch(alleles, reads, quals,
                                                      chip_smoke.GAP_ZERO)[0], "cuda")
            pos = phc.positional_args(alleles, reads, quals, chip_smoke.GAP_ONT, hop, "cuda")
            timed[name] = [dev]
            others[name] = (zero, pos)
    if args.real:  # phase (d)'s own K3 launches, saved by chip_smoke.py
        real = [tuple(t.cuda() for t in launch) for launch in torch.load(args.real)]
        k3_sets += [(f"main_path_launch_{k}", dev) for k, dev in enumerate(real)]
        timed["main_path_launches"] = real

    ok = True
    for name, dev in k3_sets:
        ref = phc.general_forward_reference(*dev)
        for v, (lib, spec) in variants.items():
            tile = _tile(spec, dev[0].shape[1])
            err = _rel_err(libs[lib]("vlt_pairhmm_general", *dev, tile=tile or ()), ref)
            report["variants"][v]["tiles"][name] = tile
            report["variants"][v]["max_rel_err"][name] = err
            ok &= err is not None and err <= TOL

    def rotated(names, k):
        order = names[k % len(names):] + names[:k % len(names)]
        return order[::-1] if k % 2 else order

    def run_all(lib, launches, tile_of):
        for dev in launches:
            libs[lib]("vlt_pairhmm_general", *dev, tile=tile_of(dev[0].shape[1]) or ())

    for k in range(args.rounds):
        for v in rotated(list(variants), k):
            lib, spec = variants[v]
            for sname, launches in timed.items():
                t = _ms(lambda: run_all(lib, launches, lambda Xp: _tile(spec, Xp)), 10)
                report["variants"][v]["ms"].setdefault(sname, []).append(t)
        for lib in rotated(list(libs), k):
            for sname, (zero, pos) in others.items():
                for fn, xs in (("vlt_pairhmm_exact", zero), ("vlt_pairhmm_positional", pos)):
                    t = _ms(lambda: libs[lib](fn, *xs), 10)
                    report["libraries"][lib]["ms"].setdefault(fn, {}).setdefault(sname, []).append(t)
    for name, rep in report["libraries"].items():
        rep["median_ms"] = {fn: {s: statistics.median(v) for s, v in per.items()}
                            for fn, per in rep["ms"].items()}
        print(json.dumps({"library": name, "kernels": rep["kernels"],
                          "median_ms": rep["median_ms"]}), flush=True)
    for v, rep in report["variants"].items():
        rep["median_ms"] = {s: statistics.median(x) for s, x in rep["ms"].items()}
        errs = [e for e in rep["max_rel_err"].values()]
        print(json.dumps({"variant": v, "tiles": {s: t for s, t in rep["tiles"].items()
                                                  if s in timed or s == "main_path_launch_0"},
                          "worst_rel_err": None if None in errs else max(errs),
                          "failed_sets": [s for s, e in rep["max_rel_err"].items()
                                          if e is None or e > TOL],
                          "median_ms": rep["median_ms"]}), flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "k3_variants.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
