"""Multi-device dry run of the sharded calling step (the port's counterpart
of ``__graft_entry__.py:dryrun_multichip``).

    python -m varlociraptor_tpu_torch.parallel.dryrun [N_DEVICES] [--device cpu]

Over an N-shard mesh it runs (1) the engine on a sharded locus batch, held
to the single-device ``engine.run``; (2) the complete calling step on
synthetic pileups (observation files written by the port's
``ObservationWriter``) through the sharded ``call_generic``, byte-identical
to the single-device run of the same dense program (``wire_mode =
"panels"``) and within 1.1e-4 of the default wire route; (3) the collective
global FDR (``control_fdr_sharded``) on the calls.  ``device="cpu"`` shards
over ``["cpu"] * N``; on the card every shard is a card of its own.
"""

from __future__ import annotations

import math
import re
import tempfile
from pathlib import Path

import numpy as np

_NUM = re.compile(r"-?\d+\.\d+|inf")


def _obs(alt: bool):
    from ..evidence.observation import ReadObservation, set_prob_mapping, set_prob_overlap

    o = ReadObservation()
    set_prob_mapping(o, -1e-9)
    o.prob_alt = -1e-9 if alt else math.log(1e-6)
    o.prob_ref = math.log(1e-6) if alt else -1e-9
    o.prob_missed_allele = math.log(0.5)
    o.prob_sample_alt = 0.0
    set_prob_overlap(o, -math.inf)
    return o


def _write_pileups(work: Path, n_loci: int):
    """Tumor / normal observation files: every third locus somatic, 3-6 alt
    reads of 10 in the tumor."""
    from ..calling.observations import ObservationWriter
    from ..calling.variants import VariantInfo
    from ..evidence.observation import Pileup

    rng = np.random.default_rng(0)
    paths = {}
    for sample in ("tumor", "normal"):
        path = work / f"{sample}.obs.jsonl"
        with ObservationWriter(path, sample_name=sample) as w:
            for i in range(n_loci):
                somatic = i % 3 == 0
                n_alt = int(rng.integers(3, 7)) if somatic and sample == "tumor" else 0
                pile = Pileup(
                    read_observations=[_obs(True) for _ in range(n_alt)]
                    + [_obs(False) for _ in range(10 - n_alt)]
                )
                info = VariantInfo(
                    kind="snv", chrom="chr1", pos=100 + i * 50,
                    ref_allele="A", alt_allele="T", alt_base="T",
                )
                w.write_record(info, pile)
        paths[sample] = path
    return paths


def _require(ok, what):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _within_wire_tolerance(text_mesh, text_wire):
    """Every line equal but for its numbers, each within 1.1e-4 * max(1, |x|)
    (the tolerance __graft_entry__.py accepts between two programs)."""
    la, lb = text_mesh.splitlines(), text_wire.splitlines()
    if len(la) != len(lb):
        return f"line counts differ: {len(la)} vs {len(lb)}"
    for a, b in zip(la, lb):
        if _NUM.sub("#", a) != _NUM.sub("#", b):
            return f"{a!r} != {b!r}"
        for xa, xb in zip(_NUM.findall(a), _NUM.findall(b)):
            if "inf" in (xa, xb):
                if xa != xb:
                    return f"{xa} != {xb} in {a!r}"
            elif abs(float(xa) - float(xb)) > 1.1e-4 * max(1.0, abs(float(xa))):
                return f"{xa} != {xb} in {a!r}"
    return None


def dryrun_multichip(n_devices: int, device="cuda", work=None) -> dict:
    """Run the sharded engine, the sharded call and the collective FDR over
    ``n_devices`` shards; raise AssertionError on a mismatch.  Files go to
    ``work`` (default: a temporary directory, removed).  Returns what was
    checked."""
    if work is None:
        with tempfile.TemporaryDirectory(prefix="vlt-dryrun-") as tmp:
            return dryrun_multichip(n_devices, device, Path(tmp))
    from ..bench_utils import engine_inputs, tumor_normal_engine
    from ..calling import fastcall
    from ..calling.call import CallOptions, call_generic
    from ..compare import compare_outputs
    from ..filtration.fdr import control_fdr_sharded
    from ..grammar.scenario import tumor_normal_scenario
    from ..io.vcf import VcfReader
    from .sharding import locus_mesh, run_sharded

    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    devices = (["cpu"] * n_devices if device == "cpu"
               else [f"cuda:{i}" for i in range(n_devices)])
    mesh = locus_mesh(devices)

    # (1) the engine on a sharded batch against one device
    _, engine = tumor_normal_engine(resolution=0.1, device=device)
    inputs = engine_inputs(engine, n_loci=n_devices * 4, depth=8)
    out = run_sharded(engine, mesh, *inputs)
    _require(out["posteriors"].shape[0] == n_devices * 4, "engine rows")
    _require(np.isfinite(out["marginal"]).all(), "non-finite marginal")
    problems, _ = compare_outputs(engine.run(*inputs), out)
    _require(not problems, problems[:3])

    # (2) the complete sharded calling step on synthetic pileups
    n_loci = max(n_devices * 3, 6)
    obs_paths = _write_pileups(work, n_loci)
    scenario = tumor_normal_scenario(0.75)
    options = CallOptions(batch_size=n_loci)
    calls = work / "calls.vcf"
    n = call_generic(scenario, obs_paths, calls, options, mesh=mesh, device=device)
    _require(n == n_loci, f"called {n} of {n_loci}")
    # the single-device run of the same dense program: byte-identical
    calls_single = work / "calls_single.vcf"
    saved = fastcall.ColumnarCaller.wire_mode
    try:
        fastcall.ColumnarCaller.wire_mode = "panels"
        n1 = call_generic(scenario, obs_paths, calls_single, options, device=device)
    finally:
        fastcall.ColumnarCaller.wire_mode = saved
    _require(n1 == n_loci, f"called {n1} of {n_loci}")
    _require(calls.read_bytes() == calls_single.read_bytes(),
             "the sharded dense path diverges from the single-device panels program")
    # the default single-buffer wire route: equal within the formatting ulp
    calls_wire = work / "calls_wire.vcf"
    n2 = call_generic(scenario, obs_paths, calls_wire, options, device=device)
    _require(n2 == n_loci, f"called {n2} of {n_loci}")
    problem = _within_wire_tolerance(calls.read_text(), calls_wire.read_text())
    _require(problem is None, problem)

    # (3) the collective global FDR on the calls
    filtered = work / "filtered.vcf"
    kept = control_fdr_sharded(
        [calls], filtered, ["somatic_tumor"], alpha=0.2, mesh=mesh
    )
    _require(0 < kept <= n_loci, f"kept {kept} of {n_loci}")
    _require(len(VcfReader(filtered).records()) == kept, "kept records")
    return {"n_devices": n_devices, "devices": [str(d) for d in mesh.devices],
            "engine_loci": n_devices * 4, "call_loci": n_loci, "fdr_kept": kept}


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int,
                    help="shards (default: every card; 8 with --device cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    n = args.n_devices or (torch.cuda.device_count() if args.device == "cuda" else 8)
    print(dryrun_multichip(n, args.device))


if __name__ == "__main__":
    main()
