"""Agreement checks between two runs of the call stage (JAX vs port, kernel vs
plain, card vs CPU), with the tolerances the port is held to.

All values are float32 computations whose sums run in another order than
XLA's (or another kernel's), so exact equality is not expected:

====================================  ==========================================
posteriors, marginal, joint           1e-4 * max(1, |x|), same finiteness
af                                    1e-4 (see AF_TOL); on a flat density
                                      peak, anywhere on the plateau
densities_dphred                      +-1 deci-PHRED (int16 rounding); a top-K
                                      cut may swap points of equal density
best_nonartifact, map_slot, n_obs     exact
VCF numbers                           1.1e-4 * max(1, |x|); AFD values +-0.1
                                      PHRED; all other text byte-identical
observations (preprocess)             prob_alt, prob_ref, prob_missed_allele:
                                      5e-4 * max(1, |x|) plus one float16 step
                                      of the file, or both below -30; every
                                      other field and count identical
====================================  ==========================================

The functions return a list of problems (empty = agreement) and report the
allowed top-K swaps separately, so callers can list them.
"""

from __future__ import annotations

import re

import numpy as np

# MAP AF: the log-parabola through the density peak amplifies the one-ulp
# float32 rounding of read-summed log-likelihoods of magnitude ~600
# (6e-5 absolute) into up to ~3.5e-5 of AF on the 0.01 grid (measured
# between the JAX package and the port on the CPU, where both are equally
# far from a float64 evaluation).  1e-4 is the AF column's printed
# resolution.
AF_TOL = 1e-4
REL_TOL = 1e-4
VCF_REL_TOL = 1.1e-4
DPHRED_SENTINEL = 32767
# Observation log-probs derived from the pair-HMM forward.  Below OBS_FLOOR
# (a normalised allele probability under 1e-13) the float32 forward works at
# its underflow edge, where the order of roundings (and whether denormals are
# flushed: XLA on the CPU and the TPU flush them, torch and the card keep
# them) moves the value by whole units; such a read says nothing for the
# allele in either run.
OBS_REL_TOL = 5e-4
OBS_FLOOR = -30.0


def _rel_close(a, b, tol):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    fin = np.isfinite(a)
    if not np.array_equal(fin, np.isfinite(b)):
        return False, np.inf
    if not np.array_equal(a[~fin], b[~fin]):
        return False, np.inf
    if not fin.any():
        return True, 0.0
    err = float(np.max(np.abs(a[fin] - b[fin]) / np.maximum(1.0, np.abs(a[fin]))))
    return err <= tol, err


def compare_dphred(ref, got):
    """[L,S,G] int16 AFDs.  Returns (problems, swaps): shipped points agree
    within +-1; where the shipped point sets differ (a top-K cut between
    points of equal quantised density) the swapped points' values agree
    within +-1.  ``swaps`` lists (locus, sample) of such rows."""
    ref = np.asarray(ref).astype(np.int64)
    got = np.asarray(got).astype(np.int64)
    problems, swaps = [], []
    if ref.shape != got.shape:
        return [f"densities_dphred shape {ref.shape} != {got.shape}"], swaps
    sr = ref != DPHRED_SENTINEL
    sg = got != DPHRED_SENTINEL
    both = sr & sg
    if both.any() and np.max(np.abs(ref[both] - got[both])) > 1:
        problems.append(
            f"densities_dphred differ by {np.max(np.abs(ref[both] - got[both]))}"
        )
    for li, si in zip(*np.nonzero((sr != sg).any(axis=-1))):
        only_r = np.sort(ref[li, si][sr[li, si] & ~sg[li, si]])
        only_g = np.sort(got[li, si][sg[li, si] & ~sr[li, si]])
        if len(only_r) != len(only_g) or np.any(np.abs(only_r - only_g) > 1):
            problems.append(
                f"densities_dphred locus {li} sample {si}: shipped points "
                f"differ ({only_r.tolist()} vs {only_g.tolist()})"
            )
        else:
            swaps.append((int(li), int(si)))
    return problems, swaps


def _af_on_plateau(ref_dphred, grid_values, a, b, af_tol):
    """Whether MAP AFs a and b both lie on the reference's flat density
    peak: the shipped AFD points (3 or more) within one deci-PHRED of the
    densest one.  There the peak is flat at the output's own resolution and
    the log-parabola vertex is ill-conditioned (low-depth loci)."""
    shipped = ref_dphred != DPHRED_SENTINEL
    if not shipped.any():
        return False
    best = ref_dphred[shipped].min()
    plateau = shipped & (ref_dphred <= best + 1)
    if plateau.sum() < 3:
        return False
    lo = float(grid_values[plateau].min()) - af_tol
    hi = float(grid_values[plateau].max()) + af_tol
    return lo <= a <= hi and lo <= b <= hi


def compare_outputs(ref, got, grid_values=None, af_tol=AF_TOL):
    """Engine host dicts (``run`` / ``run_wire`` outputs).  ``grid_values``
    (the engine's shared grid) enables the flat-peak rule for af.  Returns
    (problems, info) with info = {"max_rel": {...}, "af_max": x,
    "af_flat": [...], "topk_swaps": [...]}."""
    problems = []
    info = {"max_rel": {}, "af_flat": []}
    for k in ("posteriors", "marginal", "joint"):
        ok, err = _rel_close(ref[k], got[k], REL_TOL)
        info["max_rel"][k] = err
        if not ok:
            problems.append(f"{k}: max rel err {err}")
    a, b = np.asarray(ref["af"]), np.asarray(got["af"])
    if a.shape != b.shape:
        problems.append(f"af: shape {a.shape} != {b.shape}")
    else:
        diff = np.abs(a - b)
        info["af_max"] = float(diff.max()) if a.size else 0.0
        dph = np.asarray(ref["densities_dphred"]).astype(np.int64)
        for li, si in zip(*np.nonzero(~(diff <= af_tol))):
            if grid_values is not None and _af_on_plateau(
                dph[li, si], np.asarray(grid_values), a[li, si], b[li, si], af_tol
            ):
                info["af_flat"].append((int(li), int(si)))
            else:
                problems.append(
                    f"af locus {li} sample {si}: {a[li, si]} vs {b[li, si]}"
                )
    for k in ("best_nonartifact", "map_slot", "n_obs"):
        if not np.array_equal(np.asarray(ref[k]), np.asarray(got[k])):
            n = int(np.sum(np.asarray(ref[k]) != np.asarray(got[k])))
            problems.append(f"{k}: {n} entries differ")
    p, swaps = compare_dphred(ref["densities_dphred"], got["densities_dphred"])
    problems += p
    info["topk_swaps"] = swaps
    for k in ref:
        if np.asarray(ref[k]).dtype != np.asarray(got[k]).dtype:
            problems.append(
                f"{k}: dtype {np.asarray(ref[k]).dtype} != {np.asarray(got[k]).dtype}"
            )
    return problems, info


_NUM = re.compile(r"-?\d+\.\d+|inf")


def _numbers_close(xa, xb, tol):
    if xa == "inf" or xb == "inf":
        return xa == xb
    return abs(float(xa) - float(xb)) <= tol * max(1.0, abs(float(xa)))


def _compare_afd(a, b):
    """AFD 'vaf=phred,...' strings: common points within 0.1 PHRED (one
    deci-PHRED step); points shipped by one side only must pair up with
    values within 0.1 (a top-K swap).  Returns (ok, swapped)."""
    if a == b:
        return True, False
    if "." in (a, b):
        return False, False
    da = dict(kv.split("=") for kv in a.split(","))
    db = dict(kv.split("=") for kv in b.split(","))
    for k in da.keys() & db.keys():
        if abs(float(da[k]) - float(db[k])) > 0.1 + 1e-6:
            return False, False
    only_a = sorted(float(da[k]) for k in da.keys() - db.keys())
    only_b = sorted(float(db[k]) for k in db.keys() - da.keys())
    if len(only_a) != len(only_b):
        return False, False
    if any(abs(x - y) > 0.1 + 1e-6 for x, y in zip(only_a, only_b)):
        return False, False
    return True, bool(only_a)


def compare_vcf_text(text_a, text_b, rel_tol=VCF_REL_TOL):
    """Two calls VCFs as text.  Returns (problems, swapped_lines)."""
    la, lb = text_a.splitlines(), text_b.splitlines()
    problems, swapped = [], []
    if len(la) != len(lb):
        return [f"line counts differ: {len(la)} vs {len(lb)}"], swapped
    for i, (a, b) in enumerate(zip(la, lb)):
        if a == b:
            continue
        fa, fb = a.split("\t"), b.split("\t")
        if a.startswith("#") or len(fa) != len(fb) or len(fa) < 9:
            problems.append(f"line {i + 1}: {a!r} != {b!r}")
            continue
        fmt = fa[8].split(":")
        bad = False
        line_swapped = False
        for j, (x, y) in enumerate(zip(fa, fb)):
            if x == y:
                continue
            if j >= 9:
                for key, u, v in zip(fmt, x.split(":"), y.split(":")):
                    if key == "AFD":
                        ok, sw = _compare_afd(u, v)
                        line_swapped |= sw
                    else:
                        ok = _NUM.sub("#", u) == _NUM.sub("#", v) and all(
                            _numbers_close(p, q, rel_tol)
                            for p, q in zip(_NUM.findall(u), _NUM.findall(v))
                        )
                    bad |= not ok
            else:
                bad |= not (
                    _NUM.sub("#", x) == _NUM.sub("#", y)
                    and all(
                        _numbers_close(p, q, rel_tol)
                        for p, q in zip(_NUM.findall(x), _NUM.findall(y))
                    )
                )
        if bad:
            problems.append(f"line {i + 1}: {a[:300]!r} != {b[:300]!r}")
        elif line_swapped:
            swapped.append(i + 1)
    return problems, swapped


def vcf_record_keys(text):
    """(chrom, pos, ref, alt) of every record of a VCF text."""
    return [
        tuple(line.split("\t")[:2] + line.split("\t")[3:5])
        for line in text.splitlines()
        if line and not line.startswith("#")
    ]


def _read_observations(path, n=None):
    """(variants, counts, ObsColumns, raw depth) of the first n records of an
    observation file (all records when n is None)."""
    from .calling.observations import ObservationReader, ObsColumns

    reader = ObservationReader(str(path))
    parts = []
    total = 0
    try:
        while n is None or total < n:
            w = reader.read_window(1024 if n is None else min(1024, n - total))
            if w is None:
                break
            parts.append(w)
            total += len(w[0])
    finally:
        reader.close()
    if not parts:
        return [], np.zeros(0, np.int64), ObsColumns.empty(), np.zeros(0)
    return ([v for p in parts for v in p[0]], np.concatenate([p[1] for p in parts]),
            ObsColumns.concat([p[2] for p in parts]),
            np.concatenate([np.asarray(p[3], dtype=object) for p in parts]))


def _of_kinds(obs, kinds):
    """The records of ``kinds`` (VariantInfo.kind) of ``_read_observations``'s
    (variants, counts, columns, raw depth), with their reads."""
    from .calling.observations import ObsColumns

    variants, counts, cols, depth = obs
    keep = np.array([v.kind in kinds for v in variants], dtype=bool)
    rows = np.repeat(keep, counts)
    return ([v for v, k in zip(variants, keep) if k], counts[keep],
            ObsColumns(cols.f16[rows], cols.u8[rows], cols.hil[rows], cols.third[rows],
                       cols.frag[rows]), depth[keep])


def _tie_reads(obs):
    """The number of reads of each record of ``_read_observations``'s
    (variants, counts, columns, raw depth) whose prob_alt equals prob_ref
    (in the file's float16)."""
    from .ops.compact_obs import CF_PA, CF_PR

    _, counts, cols, _ = obs
    tie = cols.f16[:, CF_PA] == cols.f16[:, CF_PR]
    record = np.repeat(np.arange(len(counts)), counts)
    return np.bincount(record[tie], minlength=len(counts))


def _of_records(obs, keep):
    """The records of ``_read_observations``'s tuple where ``keep``."""
    from .calling.observations import ObsColumns

    variants, counts, cols, depth = obs
    rows = np.repeat(keep, counts)
    return ([v for v, k in zip(variants, keep) if k], counts[keep],
            ObsColumns(cols.f16[rows], cols.u8[rows], cols.hil[rows], cols.third[rows],
                       cols.frag[rows]), depth[keep])


def compare_observation_files(ref_path, got_path, n=None, rel_tol=OBS_REL_TOL,
                              floor=OBS_FLOOR, kinds=None, ties=False):
    """Two observation files of the same candidates (first n records; with
    ``kinds``, only the records of those variant kinds).  With ``ties``, a
    record whose read counts differ by reads whose prob_alt equals prob_ref
    is left out (its other reads' per-record values then differ too): such
    a read says nothing for either allele, and whether it is kept at all
    follows the last bits of the pair-HMM's arithmetic (the JAX package's
    native and wavefront routes keep different ones).

    Returns (problems, info): records, read counts and every field the
    pair-HMM does not touch must be identical; prob_alt, prob_ref and
    prob_missed_allele agree within rel_tol * max(1, |x|) plus one float16
    step, or both lie below ``floor``.  ``info`` has the record and read
    counts, the largest relative error of each of the three columns and the
    number of read values that passed only by the floor."""
    from .ops.compact_obs import CF_PA, CF_PME, CF_PR

    a, b = _read_observations(ref_path, n), _read_observations(got_path, n)
    if kinds is not None:
        a, b = _of_kinds(a, kinds), _of_kinds(b, kinds)
    left_out = None
    if ties and len(a[1]) == len(b[1]):
        differ = a[1] != b[1]
        if np.array_equal(a[1][differ] - _tie_reads(a)[differ],
                          b[1][differ] - _tie_reads(b)[differ]):
            left_out = [int(i) for i in np.nonzero(differ)[0]]
            a, b = _of_records(a, ~differ), _of_records(b, ~differ)
    va, ca, ka, da = a
    vb, cb, kb, db = b
    problems = []
    key = lambda v: (v.chrom, v.pos, v.kind, v.ref_allele, v.alt_allele, v.svlen)  # noqa: E731
    if [key(v) for v in va] != [key(v) for v in vb]:
        problems.append(f"records differ: {len(va)} vs {len(vb)}")
        return problems, {}
    if not np.array_equal(ca, cb):
        problems.append(f"read counts differ at {int(np.argmax(ca != cb))}")
        return problems, {}
    if list(da) != list(db):
        problems.append("raw depths differ")
    for name in ("u8", "hil", "third", "frag"):
        x, y = getattr(ka, name), getattr(kb, name)
        same = np.array_equal(x, y, equal_nan=True) if x.dtype.kind == "f" else np.array_equal(x, y)
        if not same:
            problems.append(f"observation field {name} differs")
    fa = ka.f16.astype(np.float64)
    fb = kb.f16.astype(np.float64)
    hmm_cols = {"prob_alt": CF_PA, "prob_ref": CF_PR, "prob_missed_allele": CF_PME}
    other = [c for c in range(fa.shape[1]) if c not in hmm_cols.values()]
    if not np.array_equal(fa[:, other], fb[:, other], equal_nan=True):
        problems.append("an observation log-prob outside the pair-HMM's differs")
    max_rel, n_floor = {}, 0
    for name, c in hmm_cols.items():
        x, y = fa[:, c], fb[:, c]
        same = (x == y) | (np.isnan(x) & np.isnan(y))
        deep = (x < floor) & (y < floor)
        fin = np.isfinite(x) & np.isfinite(y) & ~same & ~deep
        n_floor += int((deep & ~same).sum())
        step = np.spacing(np.abs(x[fin]).astype(np.float16)).astype(np.float64)
        err = np.abs(x[fin] - y[fin])
        bad = err > rel_tol * np.maximum(1.0, np.abs(x[fin])) + step
        max_rel[name] = float(np.max(err / np.maximum(1.0, np.abs(x[fin])))) if fin.any() else 0.0
        n_bad = int(bad.sum()) + int((~same & ~deep & ~fin).sum())
        if n_bad:
            problems.append(f"{name}: {n_bad} reads out of tolerance (max rel {max_rel[name]:.3g})")
    info = {"records": len(va), "reads": int(ca.sum()), "max_rel": max_rel,
            "n_below_floor": n_floor}
    if left_out is not None:
        info["records_left_out_for_tie_reads"] = left_out
    return problems, info
