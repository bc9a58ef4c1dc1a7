"""Experimental CNV caller (tumor/normal HMM segmentation).

Port of ``src/calling/cnvs.rs:25-700`` — which the reference
ships DISABLED in its CLI (``cli.rs:641-680``); exposed here behind
``call cnvs`` with the same experimental caveat.

Model: per heterozygous-germline locus, the tumor's (allele frequency,
depth) pair is scored against CNV states (gain in -2..20 x subclone
fraction in {0.1..1.0}; cnvs.rs:373-401): the expected tumor VAF shifts
with the gained/lost allele and the expected depth scales with
``purity * (af*(2+gain)/2 + 1-af) + (1-purity)`` (cnvs.rs:637-661);
emissions are binomial (VAF) and Poisson (depth) pmfs mixed with the
germline-het posterior (cnvs.rs:505-521).  Segmentation is Viterbi over a
uniform keep/change transition matrix derived from ``--min-bayes-factor``
(cnvs.rs:404-415).

Device shape: the emission matrix [T loci, K states] is computed as one
vectorized batch and the Viterbi recursion runs as a torch loop over loci
with O(K) work per step (the two-value transition structure needs only the
per-state keep path and the global argmax).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..io.vcf import VcfRecord, open_variant_file, open_variant_writer
from ..utils.logprob import (
    LOG_ZERO,
    np_ln_one_minus_exp,
    np_ln_sum_exp,
    np_log_from_phred,
    np_phred_from_log,
    kass_raftery,
)

MIN_DEPTH = 10  # cnvs.rs:28
MAX_GAIN = 21  # cnvs.rs:29
N_ALLELE_FREQS = 10

_KR_LETTERS = "NBPSV"


@dataclass
class Locus:
    """cnvs.rs Call (:566-577)."""

    prob_germline_het: float  # log
    af_tumor: float
    af_normal: float
    depth_tumor: int
    depth_normal: int
    start: int
    chrom: str
    prev_start: int | None = None
    next_start: int | None = None


def _ln_binom_pmf(k, p, n):
    """binomial_pdf in log space, vectorized."""
    k = np.asarray(k, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lp = np.where(p > 0, np.log(p), LOG_ZERO)
        l1p = np.where(p < 1, np.log1p(-p), LOG_ZERO)
        out = (
            _lgamma(n + 1)
            - _lgamma(k + 1)
            - _lgamma(n - k + 1)
            + np.where(k > 0, k * lp, 0.0)
            + np.where(n - k > 0, (n - k) * l1p, 0.0)
        )
    out = np.where((k < 0) | (k > n), LOG_ZERO, out)
    out = np.where((p <= 0) & (k == 0), 0.0, out)
    out = np.where((p >= 1) & (k == n), 0.0, out)
    return out


def _lgamma(x):
    from scipy.special import gammaln  # pragma: no cover - if available

    return gammaln(x)


try:  # scipy is not guaranteed; math.lgamma fallback
    import scipy.special  # noqa: F401
except ImportError:  # pragma: no cover
    _lgamma = np.vectorize(math.lgamma)


def _ln_poisson_pmf(k, lam):
    k = np.asarray(k, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64)
    with np.errstate(divide="ignore"):
        out = np.where(
            lam > 0,
            k * np.log(np.maximum(lam, 1e-300)) - lam - _lgamma(k + 1),
            np.where(k == 0, 0.0, LOG_ZERO),
        )
    return out


@dataclass
class CnvStates:
    """The HMM state grid (cnvs.rs:383-401)."""

    gain: np.ndarray  # [K] int
    allele_freq: np.ndarray  # [K] float
    purity: float

    @classmethod
    def build(cls, purity: float):
        gains, afs = [], []
        for af in np.linspace(0.1, 1.0, N_ALLELE_FREQS):
            for gain in range(-2, MAX_GAIN):
                if gain != 0 or af == 1.0:
                    gains.append(gain)
                    afs.append(af)
        return cls(np.array(gains), np.array(afs), purity)

    @property
    def n(self):
        return len(self.gain)

    def null_state(self) -> int:
        return int(np.nonzero(self.gain == 0)[0][0])

    def expected_allele_freq_alt_affected(self):
        """[K] expected tumor VAF of the alt-affected allele, NaN when
        undefined (cnvs.rs:638-651)."""
        g = self.gain.astype(np.float64)
        af = self.allele_freq
        with np.errstate(divide="ignore", invalid="ignore"):  # gain == -2
            out = af * (1.0 + g) / (2.0 + g) + (1.0 - af) * 0.5
        out = np.where(self.gain > -2, out, 0.5 if self.purity < 1.0 else np.nan)
        return out

    def expected_depth_factor(self):
        g = self.gain.astype(np.float64)
        af = self.allele_freq
        return self.purity * (af * (2.0 + g) / 2.0 + 1.0 - af) + (1.0 - self.purity)


def emission_matrix(loci: list[Locus], states: CnvStates, depth_norm_factor):
    """[T, K] observation log-probs (cnvs.rs:468-521), fully vectorized."""
    T, K = len(loci), states.n
    af_t = np.array([l.af_tumor for l in loci])
    d_t = np.array([l.depth_tumor for l in loci])
    d_n = np.array([l.depth_normal for l in loci])
    pgh = np.array([l.prob_germline_het for l in loci])

    alt_af = states.expected_allele_freq_alt_affected()  # [K]
    ref_af = 1.0 - alt_af
    k_obs = np.round(af_t * d_t)[:, None]  # [T,1]
    prob_af = np.where(
        np.isnan(alt_af)[None, :],
        0.0,
        math.log(0.5)
        + np.logaddexp(
            _ln_binom_pmf(k_obs, alt_af[None, :], d_t[:, None]),
            _ln_binom_pmf(k_obs, ref_af[None, :], d_t[:, None]),
        ),
    )
    true_depth = d_n[:, None] * depth_norm_factor * states.expected_depth_factor()[None, :]
    prob_depth = _ln_poisson_pmf(d_t[:, None], true_depth)
    prob_af_depth = prob_af + prob_depth  # [T,K]

    null = states.null_state()
    prob_null = prob_af_depth[:, null]
    return np.logaddexp(
        pgh[:, None] + prob_af_depth,
        np_ln_one_minus_exp(pgh)[:, None] + prob_null[:, None],
    )


def viterbi(obs: np.ndarray, min_bayes_factor: float, device="cuda"):
    """Max-product decoding with uniform keep/change transitions
    (cnvs.rs:404-415,505-511); O(K) per locus, one step after another on
    ``device`` ("cuda" or "cpu").

    The recursion runs in float32 (the emissions are rounded to float32
    first, the transition logs at each addition) and takes the first index
    among equal maxima: ``stay >= move`` and the argmax decide the states,
    so near-ties go the same way on every device.  Each step records the
    argmax of the previous column and which states keep their own path; the
    back-trace runs on the host."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    T, K = obs.shape
    eps = min_bayes_factor - 1.0
    denom = K + eps
    keep = math.log((1.0 + eps) / denom)
    change = math.log(1.0 / denom)
    init = np.full(K, -math.log(K)) + obs[0]

    f32 = torch.float32
    delta = torch.as_tensor(init, dtype=f32).to(dev)
    ob = torch.as_tensor(np.asarray(obs[1:]), dtype=f32).to(dev)
    take_stay = torch.empty((T - 1, K), dtype=torch.bool, device=dev)
    args = []
    with torch.no_grad():
        for t in range(T - 1):
            best, arg = torch.max(delta, dim=0)
            stay = delta + keep
            move = best + change
            torch.ge(stay, move, out=take_stay[t])
            delta = ob[t] + torch.where(take_stay[t], stay, move)
            args.append(arg)
        arg_all = (torch.stack(args) if args else
                   torch.zeros(0, dtype=torch.int64, device=dev)).cpu().numpy()
        take = take_stay.cpu().numpy()
        last = delta.cpu().numpy()
    states = np.zeros(T, dtype=np.int64)
    states[-1] = int(np.argmax(last))
    for t in range(T - 2, -1, -1):
        k = states[t + 1]
        states[t] = k if take[t, k] else arg_all[t]
    return states


def _prob_no_cnv(obs_group: np.ndarray, states: CnvStates) -> float:
    """Posterior of no CNV over the segment (cnvs.rs:426-449): Simpson over
    each gain's allele-frequency spectrum vs the null likelihood."""
    per_state = obs_group.sum(axis=0)  # [K]
    likelihoods = [per_state[states.null_state()]]
    for gain in range(-2, MAX_GAIN):
        if gain == 0:
            continue
        idxs = np.nonzero(states.gain == gain)[0]
        n = len(idxs) - 1
        if n < 3 or n % 2 == 0:
            likelihoods.append(np_ln_sum_exp(per_state[idxs]) - math.log(len(idxs)))
            continue
        vals = per_state[idxs[:n]]
        h = 1.0 / (n - 1)
        coefs = np.full(n, math.log(4.0))
        coefs[0::2] = math.log(2.0)
        coefs[0] = coefs[-1] = 0.0
        likelihoods.append(math.log(h / 3.0) + np_ln_sum_exp(vals + coefs))
    total = np_ln_sum_exp(np.array(likelihoods))
    p = likelihoods[0] - total
    return min(p, 0.0)


def _depth_map(obs_path):
    """(chrom, pos) -> raw depth observation from a preprocess observation
    file (the depth-observation channel; the reference's unfilled
    placeholder depth_observation.rs / sample.rs:330 TODO)."""
    from .ref_obs import open_observations

    out = {}
    n_records = 0
    reader = open_observations(obs_path)
    for variant, pileup in reader:
        n_records += 1
        if pileup.raw_depth is not None:
            out[(variant.chrom, variant.pos)] = int(pileup.raw_depth)
    reader.close()
    if n_records and not out:
        import sys

        print(
            f"warning: {obs_path} carries no depth observations (reference "
            "v15 BCF observation files have no depth channel; use the "
            "native .jsonl format from preprocess) — falling back to the "
            "calls' FORMAT DP",
            file=sys.stderr,
        )
    return out


def call_cnvs(
    calls_path,
    output_path,
    tumor_sample: str,
    normal_sample: str,
    purity: float = 1.0,
    min_bayes_factor: float = 1.01,
    max_dist: int = 10**9,
    tumor_obs=None,
    normal_obs=None,
    device="cuda",
) -> int:
    """Segment tumor/normal calls into CNVs; returns segment count.

    ``tumor_obs``/``normal_obs``: optional preprocess observation files;
    when given, per-locus depths come from their depth observations (raw
    pre-subsampling fragment coverage) instead of the calls' FORMAT DP
    (which is capped by --max-depth subsampling and weighted by mapping
    uncertainty — both undesirable for a coverage-driven CNV model).
    ``device``: where the Viterbi recursion runs ("cuda" or "cpu")."""
    from ..device import resolve_device

    device = resolve_device(device)  # before any work: no card, no call
    if min_bayes_factor <= 1.0:
        raise ValueError("--min-bayes-factor must be > 1")
    tumor_depths = _depth_map(tumor_obs) if tumor_obs else None
    normal_depths = _depth_map(normal_obs) if normal_obs else None
    reader = open_variant_file(calls_path)
    records = reader.records()  # also populates sample_names from #CHROM
    # ##contig lengths for the trailing CIEND bound (cnvs.rs CNVCall write)
    contig_lengths: dict[str, int] = {}
    for line in reader.header_lines:
        if line.startswith("##contig=") and "length=" in line:
            body = line.split("<", 1)[-1].rstrip(">")
            fields = dict(
                kv.split("=", 1) for kv in body.split(",") if "=" in kv
            )
            if "ID" in fields and "length" in fields:
                try:
                    contig_lengths[fields["ID"]] = int(fields["length"])
                except ValueError:
                    pass
    sample_idx = {n: i for i, n in enumerate(reader.sample_names)}
    ti, ni = sample_idx[tumor_sample], sample_idx[normal_sample]

    loci: list[Locus] = []
    for rec in records:
        raw = rec.info_get("PROB_GERMLINE_HET")
        if raw is None or raw is True:
            continue
        try:
            phred = float(str(raw).split(",")[0])
        except ValueError:
            continue
        if math.isnan(phred):
            continue
        pgh = np_log_from_phred(phred)
        if pgh < math.log(0.5):
            continue
        try:
            d_t = int(float(rec.samples[ti].get("DP", "0")))
            d_n = int(float(rec.samples[ni].get("DP", "0")))
            af_t = float(rec.samples[ti].get("AF", "0"))
            af_n = float(rec.samples[ni].get("AF", "0"))
        except (ValueError, IndexError):
            continue
        if tumor_depths is not None:
            d_t = tumor_depths.get((rec.chrom, rec.pos), d_t)
        if normal_depths is not None:
            d_n = normal_depths.get((rec.chrom, rec.pos), d_n)
        if d_n < MIN_DEPTH:
            continue
        loci.append(
            Locus(min(pgh, 0.0), af_t, af_n, d_t, d_n, rec.pos, rec.chrom)
        )
    for i, l in enumerate(loci):
        if i > 0 and loci[i - 1].chrom == l.chrom:
            l.prev_start = loci[i - 1].start
        if i + 1 < len(loci) and loci[i + 1].chrom == l.chrom:
            l.next_start = loci[i + 1].start

    # group into regions (same contig, gap <= max_dist; cnvs.rs:176-205)
    regions: list[list[Locus]] = []
    for l in loci:
        if (
            regions
            and regions[-1][-1].chrom == l.chrom
            and l.start - regions[-1][-1].start <= max_dist
        ):
            regions[-1].append(l)
        else:
            regions.append([l])

    if not loci:
        depth_norm_factor = 1.0
    else:
        depth_norm_factor = float(
            np.mean([l.depth_tumor for l in loci])
            / max(np.mean([l.depth_normal for l in loci]), 1e-9)
        )
    states = CnvStates.build(purity)

    header = [
        '##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise structural variation">',
        '##INFO=<ID=CN,Number=1,Type=Integer,Description="Copy number in tumor sample">',
        '##INFO=<ID=VAF,Number=1,Type=Float,Description="Subclone fraction affected by the CNV.">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End of copy number variation.">',
        '##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS">',
        '##INFO=<ID=CIEND,Number=2,Type=Integer,Description="Confidence interval around END">',
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="CNV length.">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type.">',
        '##INFO=<ID=LOCI,Number=1,Type=Integer,Description="Number of contained loci.">',
        '##INFO=<ID=OBS,Number=1,Type=String,Description="Per-locus Kass-Raftery support vs no CNV">',
        '##FORMAT=<ID=LOCI_DP,Number=.,Type=Integer,Description="Depths of contained loci.">',
        '##FORMAT=<ID=LOCI_VAF,Number=.,Type=Float,Description="VAFs of contained loci.">',
    ]
    n_out = 0
    null = states.null_state()
    with open_variant_writer(
        output_path, sample_names=[tumor_sample, normal_sample], header_lines=header
    ) as w:
        for region in regions:
            obs = emission_matrix(region, states, depth_norm_factor)
            path = (viterbi(obs, min_bayes_factor, device) if len(region) > 1
                    else np.array([null]))
            # contiguous same-state groups (cnvs.rs:224-258)
            t = 0
            while t < len(region):
                u = t
                while u + 1 < len(region) and path[u + 1] == path[t]:
                    u += 1
                state = int(path[t])
                group = region[t : u + 1]
                if states.gain[state] != 0 and len(group) > 1:
                    seg_obs = obs[t : u + 1]
                    prob_no_cnv = _prob_no_cnv(seg_obs, states)
                    bfs = seg_obs[:, state] - seg_obs[:, null]
                    letters = "".join(
                        _KR_LETTERS[kass_raftery(math.exp(min(bf, 700.0)))]
                        for bf in bfs
                    )
                    first, last = group[0], group[-1]
                    end = last.start + 1
                    info = {
                        "END": str(end),
                        "SVLEN": str(end - first.start + 1),
                        "CN": str(2 + int(states.gain[state])),
                        "VAF": f"{states.allele_freq[state]:.4f}",
                        "LOCI": str(len(group)),
                        "SVTYPE": "CNV",
                        "IMPRECISE": True,
                        "CIPOS": (
                            f"{-(first.start - first.prev_start) if first.prev_start is not None else -first.start},0"
                        ),
                        "CIEND": (
                            # no successor locus: CI extends to the contig
                            # end like the reference (cnvs.rs CNVCall write)
                            f"0,{(last.next_start - end) if last.next_start is not None else max(contig_lengths.get(last.chrom, end) - end, 0)}"
                        ),
                        "OBS": letters,
                    }
                    samples = [
                        {
                            "LOCI_DP": ",".join(str(l.depth_tumor) for l in group),
                            "LOCI_VAF": ",".join(f"{l.af_tumor:.4f}" for l in group),
                        },
                        {
                            "LOCI_DP": ",".join(
                                str(int(round(l.depth_normal * depth_norm_factor)))
                                for l in group
                            ),
                            "LOCI_VAF": ",".join(f"{l.af_normal:.4f}" for l in group),
                        },
                    ]
                    w.write(
                        VcfRecord(
                            chrom=first.chrom,
                            pos=first.start,
                            id=".",
                            ref="N",
                            alts=["<CNV>"],
                            qual=f"{np_phred_from_log(prob_no_cnv):.2f}",
                            info=info,
                            format=["LOCI_DP", "LOCI_VAF"],
                            samples=samples,
                        )
                    )
                    n_out += 1
                t = u + 1
    return n_out
