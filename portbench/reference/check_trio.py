"""Whether the trio call window's calls and FDR sets are right.

The numbers and their meaning are ``check_call``'s (``calls_differ``,
``records_missing``, ``prob_gap``, ``af_gap``, ``fdr_differ``), its VCF
parser, gaps, FDR rule and draw of the checked loci; the reference is
``trio_model`` (the joint prior with Mendelian inheritance, --full-prior)
on the candidates drawn by ``calls_input_trio``.  The limits are set in
``LIMITS`` from the readings that ``PERF.md`` lists.
"""

from __future__ import annotations

from . import trio_model
from .check_call import _digest, call_gaps, fdr_keep, parse_calls, pick_loci

# set from the sound runs' and the control's readings (PERF.md): prob_gap
# well above the VCF's print precision (~1.2e-5), below what dropping the
# Mendelian term from the program's prior reads (4.9e-4 and more)
LIMITS = {"calls_differ": 0, "records_missing": 0, "prob_gap": 2e-4, "af_gap": 0.011,
          "fdr_differ": 0}


def check(inputs, config, traffic, calls, seed):
    """[(name, value, limit)] of the window's calls against the reference."""
    from portbench.lib import calls_input

    first = [_digest(p) for p in calls[0]]
    differ = sum(1 for c in calls[1:] if [_digest(p) for p in c] != first)
    vcf, fdr_vcf = calls[-1]
    got = parse_calls(vcf)
    keys = {(int(p) + 1, str(r), str(a))
            for p, r, a in zip(inputs["pos"], inputs["ref"], inputs["alt"])}
    missing = len(keys ^ set(got))
    loci = pick_loci(len(inputs["pos"]), traffic["check_loci"], seed)
    ref = trio_model.calls(calls_input.select(inputs, loci), config)
    present = {k: v for k, v in ref.items() if k in got}
    missing += len(ref) - len(present)
    pg, ag = call_gaps(present, got)
    fdr = config["fdr"]
    kept = fdr_keep(vcf, [e.lower() for e in fdr["events"]], fdr["alpha"])
    differ_fdr = len(kept ^ set(parse_calls(fdr_vcf)))
    values = {"calls_differ": differ, "records_missing": missing, "prob_gap": pg,
              "af_gap": ag, "fdr_differ": differ_fdr}
    return [(name, values[name], LIMITS[name]) for name in LIMITS]
