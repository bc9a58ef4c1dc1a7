"""Pair-HMM tile variants, and earlier pair-HMM libraries, timed against each other on one card.

    python scripts/torch_k3_variants.py [--kernel exact|general|positional]
        [--old OLD.cu ...] [--variants new new:r8 new:l32 OLD ...]
        [--real LAUNCHES.pt] [--rounds 5] [--out DIR]

Builds ``varlociraptor_tpu_torch/csrc/pairhmm_column.cu`` ("new") and each
``--old`` source (an earlier ``pairhmm_column.cu``, e.g. ``git show
<commit>:varlociraptor_tpu_torch/csrc/pairhmm_column.cu``, named by its file
stem) with ``-Xptxas -v``, one nvcc per source, all at once.  ``--kernel``
picks the kernel under study: K2 (``exact``), K3 (``general``, the default)
or K4 (``positional``).  A variant is a library and, for a library whose
entry of that kernel takes a tile, a tile policy: ``:rN`` caps the rows per
lane at N, ``:lN`` fixes N lanes per item, and the tile is then the one
``ops/pairhmm_column.general_tile`` picks under those limits (no suffix:
the kernel's default, ``exact_tile``, ``general_tile`` or
``positional_tile``).  Each variant is held to the kernel's plain version
on every set of ``chip_smoke.py`` phase (a') (K2, K3) or (a'') (K4) (1e-4 x
max(1, |x|), the same finiteness and -1e30 items), then all variants are
timed with CUDA events (``chip_smoke.cuda_ms`` with the card held ahead, so
that the host queues every call before the first runs) in rounds that
rotate their order, at the three timed shapes (4096 x 160 x 100, 16384 x
256 x 150 and the kernel's main-path shape, ``chip_smoke.K2_MAIN_SHAPE``,
``K3_MAIN_SHAPE`` or ``K4_MAIN_SHAPE``) and, with ``--real``, on the
main-path launches that ``chip_smoke.py`` phase (d) (K2, K3) or (e) (K4)
saved (each held to the plain version too, timed as one run of all of
them).  The other two pair-HMM kernels of every library are timed beside
them at the three shapes, at their default tiles.  Prints the card's name
and power limit, one JSON line per library (registers and spills of each
kernel, the other kernels' median ms) and per variant (tiles, errors,
median ms), and writes all of it to DIR/<kernel>_variants.json.  Needs a
CUDA device and nvcc; exits non-zero without them or when a variant
disagrees with the plain version.
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
# per kernel under study: its C entry, plain version, default tile policy,
# sets and main-path shape
KERNELS = {
    "exact": ("vlt_pairhmm_exact", phc.exact_forward_reference, phc.exact_tile,
              chip_smoke.pairhmm_sets, chip_smoke.K2_MAIN_SET),
    "general": ("vlt_pairhmm_general", phc.general_forward_reference, phc.general_tile,
                chip_smoke.pairhmm_sets, chip_smoke.MAIN_SET),
    "positional": ("vlt_pairhmm_positional", phc.positional_forward_reference,
                   phc.positional_tile, chip_smoke.positional_sets, chip_smoke.K4_MAIN_SET),
}


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
        """tiled: {C entry: whether it takes a tile}."""
        self.lib = ctypes.CDLL(str(path))
        self.tiled = tiled
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, n_ptr in (("vlt_pairhmm_exact", 7), ("vlt_pairhmm_general", 7),
                          ("vlt_pairhmm_positional", 10)):
            getattr(self.lib, fn).argtypes = [p] * n_ptr + [i] * (5 if tiled[fn] else 3) + [p]

    def __call__(self, fn_name, allele, read, *tensors, tile=()):
        B, Xp = allele.shape
        out = torch.empty(B, dtype=torch.float32, device=allele.device)
        err = getattr(self.lib, fn_name)(
            *[t.data_ptr() for t in (allele, read, *tensors, out)], B, Xp, read.shape[1],
            *tile, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{fn_name}: CUDA error {err}")
        return out


def _tile(spec, Xp, default):
    """The tile of a variant spec's policy at panel width Xp (None: the
    library picks its own; no limits: ``default``)."""
    if spec is None:
        return None
    if not spec:
        return default(Xp)
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
    return chip_smoke.cuda_ms(fn, iters, ahead=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="general")
    ap.add_argument("--old", nargs="*", default=[], help="earlier pairhmm_column.cu sources")
    ap.add_argument("--variants", nargs="*", default=["new"],
                    help="LIB[:rN][:lN]: a library (new, or an --old stem) and a tile policy")
    ap.add_argument("--real", help="launches saved by chip_smoke.py phase (d) or (e) "
                                   f"(build/chip_smoke/{chip_smoke.K2_LAUNCHES_FILE}, "
                                   f"build/chip_smoke/{chip_smoke.K3_LAUNCHES_FILE}, "
                                   f"build/chip_smoke/homopolymer/{chip_smoke.K4_LAUNCHES_FILE})")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "build" / "k3_variants"))
    args = ap.parse_args(argv)
    entry, reference, default_tile, sets_of, main_set = KERNELS[args.kernel]
    shapes = ("b4096_x160_y100", chip_smoke.BENCH_SET, main_set)
    if not torch.cuda.is_available():
        print("k3_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = Path(args.out)
    jobs = {"new": CSRC / "pairhmm_column.cu"}
    jobs.update({Path(p).stem: Path(p) for p in args.old})
    built = _compile(jobs, out_dir / "libs")
    tiled = {name: {fn: re.search(fn + r"\([^)]*int lanes", src.read_text()) is not None
                    for fn in ("vlt_pairhmm_exact", "vlt_pairhmm_general",
                               "vlt_pairhmm_positional")}
             for name, src in jobs.items()}
    libs = {name: Library(lib, tiled[name]) for name, (lib, _) in built.items()}
    variants = {}
    for v in args.variants:
        lib, *spec = v.split(":")
        variants[v] = (lib, spec if tiled[lib][entry] else None)
    # the other two kernels of each library, at their default tiles
    others_fn = [fn for fn in ("vlt_pairhmm_exact", "vlt_pairhmm_general",
                               "vlt_pairhmm_positional") if fn != entry]
    other_tile = {"vlt_pairhmm_exact": phc.exact_tile, "vlt_pairhmm_general": phc.general_tile,
                  "vlt_pairhmm_positional": phc.positional_tile}

    from varlociraptor_tpu_torch.estimation.alignment_properties import HopParams

    hop = HopParams(*([[chip_smoke.HOP_LN] * 4] * 4))
    report = {"libraries": {name: {"kernels": info, "ms": {}} for name, (_, info) in built.items()},
              "variants": {v: {"tiles": {}, "max_rel_err": {}, "ms": {}} for v in variants}}
    checked = []  # (name, device inputs of the kernel under study)
    timed, others = {}, {}  # its launches, and the other kernels' inputs, per timed shape
    for name, alleles, reads, quals in sets_of():
        packed, _, _, _ = phc.pack_exact_batch(alleles, reads, quals, chip_smoke.GAP_ONT)
        inputs = {
            "vlt_pairhmm_exact": lambda: phc.to_device(phc.pack_exact_batch(
                alleles, reads, quals, chip_smoke.GAP_ZERO)[0], "cuda"),
            "vlt_pairhmm_general": lambda: phc.to_device(
                packed[:5] + (phc.general_coef(chip_smoke.GAP_ONT),), "cuda"),
            "vlt_pairhmm_positional": lambda: phc.positional_args(
                alleles, reads, quals, chip_smoke.GAP_ONT, hop, "cuda"),
        }
        dev = inputs[entry]()
        checked.append((name, dev))
        if name in shapes:
            timed[name] = [dev]
            others[name] = {fn: inputs[fn]() for fn in others_fn}
    if args.real:  # the main path's own launches, saved by chip_smoke.py
        real = [tuple(t.cuda() for t in launch) for launch in torch.load(args.real)]
        checked += [(f"main_path_launch_{k}", dev) for k, dev in enumerate(real)]
        timed["main_path_launches"] = real

    ok = True
    for name, dev in checked:
        ref = reference(*dev)
        for v, (lib, spec) in variants.items():
            tile = _tile(spec, dev[0].shape[1], default_tile)
            err = _rel_err(libs[lib](entry, *dev, tile=tile or ()), ref)
            report["variants"][v]["tiles"][name] = tile
            report["variants"][v]["max_rel_err"][name] = err
            ok &= err is not None and err <= TOL

    def rotated(names, k):
        order = names[k % len(names):] + names[:k % len(names)]
        return order[::-1] if k % 2 else order

    def run_all(lib, launches, tile_of):
        for dev in launches:
            libs[lib](entry, *dev, tile=tile_of(dev[0].shape[1]) or ())

    for k in range(args.rounds):
        for v in rotated(list(variants), k):
            lib, spec = variants[v]
            for sname, launches in timed.items():
                t = _ms(lambda: run_all(lib, launches, lambda Xp: _tile(spec, Xp, default_tile)),
                        10)
                report["variants"][v]["ms"].setdefault(sname, []).append(t)
        for lib in rotated(list(libs), k):
            for sname, per_fn in others.items():
                for fn, xs in per_fn.items():
                    tile = other_tile[fn](xs[0].shape[1]) if libs[lib].tiled.get(fn) else ()
                    t = _ms(lambda: libs[lib](fn, *xs, tile=tile), 10)
                    report["libraries"][lib]["ms"].setdefault(fn, {}).setdefault(sname, []).append(t)
    for name, rep in report["libraries"].items():
        rep["median_ms"] = {fn: {s: statistics.median(v) for s, v in per.items()}
                            for fn, per in rep["ms"].items()}
        print(json.dumps({"library": name, "kernels": rep["kernels"],
                          "median_ms": rep["median_ms"]}), flush=True)
    for v, rep in report["variants"].items():
        rep["median_ms"] = {s: statistics.median(x) for s, x in rep["ms"].items()}
        errs = [e for e in rep["max_rel_err"].values()]
        print(json.dumps({"variant": v, "kernel": args.kernel,
                          "tiles": {s: t for s, t in rep["tiles"].items()
                                    if s in timed or s == "main_path_launch_0"},
                          "worst_rel_err": None if None in errs else max(errs),
                          "failed_sets": [s for s, e in rep["max_rel_err"].items()
                                          if e is None or e > TOL],
                          "median_ms": rep["median_ms"]}), flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{args.kernel}_variants.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
