"""End-to-end A/B of two checkouts of the PyTorch port on one card.

    python scripts/torch_e2e_ab.py PARENT_DIR CHANGE_DIR [--order pccp]

For each letter of ``--order`` (p = PARENT_DIR, c = CHANGE_DIR) a fresh
process runs in that tree: it imports the tree's own ``chip_smoke.py``,
builds the tree's kernels, and runs its ``phase_engine`` (tumor-normal
engine at 32768 loci, depth 64, best of 3) and ``phase_cli`` (``call
variants tumor-normal`` on 100,000 synthetic loci, then FDR control), with
their own checks.  Each run prints one JSON line: its side, the engine's
loci/s and seconds, the call CLI's loci/s and seconds and its K1 launches.
A tree is a checkout of the repo, e.g. the parent commit unpacked with
``git archive <commit> | tar -x -C build/parent``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json, shutil, sys
from pathlib import Path
sys.path.insert(0, ".")
import chip_smoke as s
from varlociraptor_tpu_torch.bench_utils import tumor_normal_engine

_, engine = tumor_normal_engine(resolution=0.01, purity=0.75, device="cuda")
e = s.phase_engine(engine)
work = Path("build") / "e2e_ab"
shutil.rmtree(work, ignore_errors=True)
work.mkdir(parents=True)
c, launches = s.phase_cli(work)
print(json.dumps({"side": sys.argv[1], "engine_loci_per_s": e["loci_per_s"],
                  "engine_s": e["seconds"], "cli_loci_per_s": c["call_loci_per_s"],
                  "cli_call_s": c["call_s"], "k1_launches": launches}), flush=True)
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccp")
    args = ap.parse_args(argv)
    trees = {"p": ("parent", Path(args.parent)), "c": ("change", Path(args.change))}
    rc = 0
    for side in args.order:
        name, tree = trees[side]
        proc = subprocess.run([sys.executable, "-c", _RUN, name], cwd=tree,
                              stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout[proc.stdout.rfind('{"side"'):] if '{"side"' in proc.stdout
                         else f"{name}: no result\n")
        sys.stdout.flush()
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
