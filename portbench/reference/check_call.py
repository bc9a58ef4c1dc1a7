"""Whether the call window's calls and FDR sets are right.

* ``calls_differ``: window calls whose calls VCF or FDR VCF is not byte for
  byte the first call's (every call reads the same files); exact, limit 0;
* ``records_missing``: candidates without a record in the last call, or
  records at no candidate; exact, limit 0;
* ``prob_gap``: on ``traffic["check_loci"]`` candidates drawn from the seed,
  the largest gap between the last call's and the reference's posterior
  probability of any event (``PROB_*``, PHRED decoded to a probability);
* ``af_gap``: on the same candidates, the largest gap of any sample's MAP
  allele frequency (``AF``);
* ``fdr_differ``: records in the last call's FDR set and not in the set
  that the FDR rule keeps of the same calls, or the other way round; exact,
  limit 0.

The reference (``call_model``) computes the drawn candidates from the
generator's columns; it reads no file of the program.  The FDR rule
(``fdr_keep``) reads the program's calls only to judge the program's FDR
set.  The limits are set in ``LIMITS`` from the readings that ``PERF.md``
lists.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

from . import call_model

# set from the sound runs' and the control's readings (PERF.md)
LIMITS = {"calls_differ": 0, "records_missing": 0, "prob_gap": 1e-3, "af_gap": 0.011,
          "fdr_differ": 0}


def _prob(phred):
    if phred == ".":
        return math.nan
    if phred in ("inf", "Inf"):
        return 0.0
    return 10.0 ** (-float(phred) / 10.0)


def parse_calls(path):
    """{(pos, ref, alt): ({event: probability}, {sample: AF})} of a calls
    VCF; events in lower case as the scenario names them."""
    out = {}
    samples = []
    with open(path) as f:
        for line in f:
            if line.startswith("#CHROM"):
                samples = line.rstrip("\n").split("\t")[9:]
            if line.startswith("#"):
                continue
            col = line.rstrip("\n").split("\t")
            probs = {}
            for kv in col[7].split(";"):
                if kv.startswith("PROB_") and "=" in kv:
                    k, v = kv.split("=", 1)
                    probs[k[5:].lower()] = _prob(v)
            fmt = col[8].split(":") if len(col) > 8 else []
            af = {}
            if "AF" in fmt:
                i = fmt.index("AF")
                for name, s in zip(samples, col[9:]):
                    v = s.split(":")[i] if i < len(s.split(":")) else "."
                    af[name] = math.nan if v == "." else float(v)
            out[(int(col[1]), col[3], col[4])] = (probs, af)
    return out


def _gap(x, y):
    if math.isnan(x) and math.isnan(y):
        return 0.0
    if math.isnan(x) or math.isnan(y):
        return 1.0
    return abs(x - y)


def call_gaps(ref, got):
    """(prob_gap, af_gap) of the records of ``ref`` against ``got``."""
    pg = ag = 0.0
    for key, (probs, af) in ref.items():
        gprobs, gaf = got[key]
        for tag in set(probs) | set(gprobs):
            pg = max(pg, _gap(probs.get(tag, math.nan), gprobs.get(tag, math.nan)))
        for name in set(af) | set(gaf):
            ag = max(ag, _gap(af.get(name, math.nan), gaf.get(name, math.nan)))
    return pg, ag


def fdr_keep(calls_vcf, events, alpha):
    """Keys of the records that Bayesian FDR control keeps (Mueller,
    Parmigiani and Rice 2006): a record's probability is the sum of its
    events' posteriors; sorted by it, highest first, the expected FDR of the
    first k records is the mean of their error probabilities (1 - p); the
    threshold is the probability of the last record at which that mean is at
    most ``alpha`` and which begins its run of equal error probabilities;
    every record at or above it is kept."""
    lp = {}
    for key, (probs, _) in parse_calls(calls_vcf).items():
        vals = [probs[e] for e in events if e in probs and not math.isnan(probs[e])]
        if vals:
            lp[key] = min(math.log(sum(vals)) if sum(vals) > 0 else -math.inf, 0.0)
    order = sorted(lp.values(), reverse=True)
    pep = [math.log1p(-math.exp(p)) if p < 0 else -math.inf for p in order]
    cum = np.cumsum(np.exp(pep)) / np.arange(1, len(pep) + 1)
    threshold = None
    with np.errstate(divide="ignore"):
        efdr = np.log(np.maximum(cum, 1e-300))
    if len(efdr) and efdr[0] > math.log(alpha):
        threshold = 0.0
    else:
        for i in range(len(efdr) - 1, -1, -1):
            if efdr[i] <= math.log(alpha) and (i == 0 or pep[i] != pep[i - 1]):
                threshold = order[i]
                break
    if threshold is None:
        return set(lp)
    return {k for k, p in lp.items()
            if p > threshold or math.isclose(p, threshold, rel_tol=1e-9, abs_tol=1e-12)}


def _digest(path):
    return hashlib.sha256(path.read_bytes()).digest()


def pick_loci(n, k, seed):
    rng = np.random.default_rng([seed, 29])
    return np.sort(rng.choice(n, min(k, n), replace=False))


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
    ref = call_model.calls(calls_input.select(inputs, loci), config)
    present = {k: v for k, v in ref.items() if k in got}
    missing += len(ref) - len(present)
    pg, ag = call_gaps(present, got)
    fdr = config["fdr"]
    kept = fdr_keep(vcf, [e.lower() for e in fdr["events"]], fdr["alpha"])
    differ_fdr = len(kept ^ set(parse_calls(fdr_vcf)))
    values = {"calls_differ": differ, "records_missing": missing, "prob_gap": pg,
              "af_gap": ag, "fdr_differ": differ_fdr}
    return [(name, values[name], LIMITS[name]) for name in LIMITS]
