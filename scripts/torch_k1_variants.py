"""K1 tiling variants, and an earlier K1, timed against each other on one card.

    python scripts/torch_k1_variants.py [--old OLD.cu ...]
        [--variants 4,4,8 4,4,16,6 8,2,16,w8 ...] [--sass] [--out DIR]

Each variant (C classes x R rows per thread, K reads per log, and
optionally a number: the resident blocks per SM asked of the register
allocator, and ``wN``: N warps per block) is a copy of
``varlociraptor_tpu_torch/csrc/ll_classes.cu`` with those constants
rewritten, compiled with ``-Xptxas -v`` into a library of its own; each
``--old`` source (an earlier ``ll_classes.cu`` with the same
``vlt_ll_classes`` entry, e.g. ``git show
<commit>:varlociraptor_tpu_torch/csrc/ll_classes.cu``) is compiled as it
is.  All nvcc processes run at once.  Then, on the tumor-normal engine's own
K1 inputs (resolution 0.01, depth 64) at the bench shape (32768 loci x 4
combos = 131072 rows) and the call CLI's window (1024 loci = 4096 rows),
and on the edge sets of ``bench_utils.k1_edge_rows``, every library is held
to the plain version (5e-5 x max(1, |x|), the same finiteness) and timed
with CUDA events in rounds that rotate the order.  Prints the card's name
and power limit, one JSON line per library (registers, spills, errors,
median ms per shape) and writes the same to DIR/k1_variants.json; with
``--sass``, each library's ``cuobjdump -sass`` goes to DIR/sass_<name>.txt.  Needs a
CUDA device and nvcc; exits non-zero without them.
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

from varlociraptor_tpu_torch._build import ARCH_FLAGS, CSRC, _nvcc  # noqa: E402

TOL = 5e-5


def _variant_source(c, r, k, warps=None, min_blocks=None):
    """ll_classes.cu with its tile constants (and launch bounds) rewritten."""
    src = (CSRC / "ll_classes.cu").read_text()
    subs = [(rf"^constexpr int {name} = \d+;", f"constexpr int {name} = {value};")
            for name, value in (("C", c), ("R", r), ("K", k), ("WARPS", warps))
            if value is not None]
    if min_blocks is not None:
        subs.append((r"__launch_bounds__\(32 \* WARPS\)",
                     f"__launch_bounds__(32 * WARPS, {min_blocks})"))
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src, flags=re.M)
        if n != 1:
            raise RuntimeError(f"ll_classes.cu: {pattern!r} matched {n} times, not once")
    return src


def _compile(jobs, out_dir):
    """{name: (library path, ptxas report)}; jobs {name: source path}."""
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
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        built[name] = (lib, {"registers": regs, "spill_store_bytes": spills,
                             "ptxas": [ln.strip() for ln in log.splitlines() if "ptxas" in ln]})
    return built


def _bind(path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vlt_ll_classes.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.vlt_ll_classes.restype = i

    def run(a, r, m, psa, nu, kappa):
        N, D = a.shape
        U = nu.shape[0]
        out = torch.empty((N, U), dtype=torch.float32, device=a.device)
        err = lib.vlt_ll_classes(a.data_ptr(), r.data_ptr(), m.data_ptr(), psa.data_ptr(),
                                 nu.data_ptr(), kappa.data_ptr(), out.data_ptr(), N, U, D,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{path.name}: CUDA error {err}")
        return out

    return run


def _errors(got, ref):
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    fin = np.isfinite(r)
    if not np.array_equal(np.isfinite(g), fin):
        return None
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(g[fin] - r[fin]) / np.maximum(1.0, np.abs(r[fin]))))


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
    ap.add_argument("--old", nargs="*", default=[], help="earlier ll_classes.cu sources")
    ap.add_argument("--variants", nargs="*", default=["8,2,16"],
                    help="C,R,K[,MIN_BLOCKS][,wWARPS]")
    ap.add_argument("--sass", action="store_true", help="dump each library's SASS")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "build" / "k1_variants"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_variants: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from varlociraptor_tpu_torch.bench_utils import (
        K1_EDGE_CASES,
        k1_edge_rows,
        k1_engine_rows,
        tumor_normal_engine,
    )
    from varlociraptor_tpu_torch.ops.ll_classes import ll_classes_reference

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = Path(args.out)
    jobs = {f"old{i}_{Path(p).stem}": Path(p) for i, p in enumerate(args.old)}
    (out_dir / "src").mkdir(parents=True, exist_ok=True)
    for v in args.variants:
        c, r, k, *extra = v.split(",")
        warps = min_blocks = None
        name = f"C{c}_R{r}_K{k}"
        for x in extra:
            if x.startswith("w"):
                warps = int(x[1:])
                name += f"_W{warps}"
            else:
                min_blocks = int(x)
                name += f"_B{min_blocks}"
        src = out_dir / "src" / f"{name}.cu"
        src.write_text(_variant_source(int(c), int(r), int(k), warps, min_blocks))
        jobs[name] = src
    built = _compile(jobs, out_dir / "libs")
    if args.sass:
        cuobjdump = Path(_nvcc()).with_name("cuobjdump")
        for name, (lib, _) in built.items():
            (out_dir / f"sass_{name}.txt").write_text(subprocess.run(
                [str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True).stdout)
    fns = {name: _bind(lib) for name, (lib, _) in built.items()}

    _, engine = tumor_normal_engine(resolution=0.01, purity=0.75, device="cuda")
    shapes = {"bench_131072x711x64": k1_engine_rows(engine, 32768, 64, 0, "pair"),
              "window_4096x711x64": k1_engine_rows(engine, 1024, 64, 0, "pair")}
    sets = dict(shapes)
    sets.update({name: tuple(torch.as_tensor(x, device="cuda") for x in k1_edge_rows(name))
                 for name in K1_EDGE_CASES})
    report = {name: {**info, "max_rel_err": {}, "ms": {s: [] for s in shapes}}
              for name, (_, info) in built.items()}
    ok = True
    for sname, xs in sets.items():
        ref = ll_classes_reference(*xs)
        for name, fn in fns.items():
            err = _errors(fn(*xs), ref)
            report[name]["max_rel_err"][sname] = err
            ok &= err is not None and err <= TOL
    names = list(fns)
    for k in range(args.rounds):
        order = names[k % len(names):] + names[:k % len(names)]
        if k % 2:
            order = order[::-1]
        for name in order:
            for sname, xs in shapes.items():
                iters = 5 if sname.startswith("bench") else 50
                report[name]["ms"][sname].append(_ms(lambda: fns[name](*xs), iters))
    for name in names:
        report[name]["median_ms"] = {s: statistics.median(v) for s, v in report[name]["ms"].items()}
        print(json.dumps({"library": name, **{k: v for k, v in report[name].items()
                                              if k != "ptxas"}}), flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "k1_variants.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
