"""Locus prior over per-sample VAF vectors (host numpy).

Port of the reference's ``Prior`` (``src/variants/model/prior.rs``):
population prior from heterozygosity (Watterson ``het/m``), somatic flat-VAF
rate mass, mendelian inheritance via meiotic-split hypergeometrics + de-novo
rate, clonal/subclonal inheritance, per-sample germline-VAF enumeration, and
variant-type fraction scaling.  Scalar host code: the engine's default
absent-only mode (``prior.rs:718-761``) needs only prior(all-zero) per
(contig, variant-type); full-prior mode evaluates it on the joint grid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

LOG_ZERO = -math.inf


def _ln(p):
    return math.log(p) if p > 0 else LOG_ZERO


def _ln_sum(probs):
    m = max(probs, default=LOG_ZERO)
    if m == LOG_ZERO:
        return LOG_ZERO
    return m + math.log(sum(math.exp(p - m) for p in probs))


def _ln1m(x):
    if x >= 0.0:
        return LOG_ZERO
    if x < -math.log(2.0):
        return math.log1p(-math.exp(x))
    return math.log(-math.expm1(x))


@lru_cache(maxsize=4096)
def _hypergeom_pmf(n_total, k_success, n_draw, k_obs):
    """P(X=k_obs) for Hypergeometric(N=n_total, K=k_success, n=n_draw)."""
    if k_obs < max(0, n_draw - (n_total - k_success)) or k_obs > min(
        k_success, n_draw
    ):
        return 0.0
    return (
        math.comb(k_success, k_obs)
        * math.comb(n_total - k_success, n_draw - k_obs)
        / math.comb(n_total, n_draw)
    )


@dataclass
class Inheritance:
    kind: str  # mendelian | clonal | subclonal
    from_samples: tuple  # (p1, p2) for mendelian; (parent,) otherwise
    somatic: bool = False


@dataclass
class Prior:
    """One instance per scenario; set_* mutators mirror UpdatablePrior."""

    uniform: list  # [S] bool — sample has explicit universe
    ploidies: list  # [S] int | None
    universes: list  # [S] list[SpectrumLike] with .contains(vaf)
    germline_mutation_rate: list  # [S] float | None
    somatic_effective_mutation_rate: list  # [S] float | None
    heterozygosity: float | None
    inheritance: list  # [S] Inheritance | None
    variant_type_fraction: float = 1.0
    variant_heterozygosity: float | None = None  # linear prob
    variant_somatic_rate: float | None = None  # linear prob
    is_absent_only: bool = True
    _cache: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def n_samples(self):
        return len(self.germline_mutation_rate)

    def is_all_uniform(self):
        return all(self.uniform)

    def _vartype_het(self):
        if self.variant_heterozygosity is not None:
            return _ln(self.variant_heterozygosity)
        if self.heterozygosity is not None:
            return _ln(self.heterozygosity * self.variant_type_fraction)
        return None

    def _vartype_somatic_rate(self, sample):
        if self.variant_somatic_rate is not None:
            return _ln(self.variant_somatic_rate)
        r = self.somatic_effective_mutation_rate[sample]
        if r is not None:
            return _ln(r * self.variant_type_fraction)
        return None

    def _vartype_germline_rate(self, sample):
        r = self.germline_mutation_rate[sample]
        if r is not None:
            return r * self.variant_type_fraction
        return None

    def _is_valid_germline_vaf(self, sample, vaf):
        ploidy = self.ploidies[sample]
        n_alt = ploidy * vaf
        return abs(n_alt - round(n_alt)) < 1e-6

    def valid_vaf_mask(self, grid_values) -> "np.ndarray":
        """[S, G] bool: per-sample VAF points with nonzero prior mass.

        Mirrors the per-sample zero structure of _calc_prob
        (prior.rs:298-438): vaf 0 is always possible; otherwise a vaf is
        impossible on ploidy-0 contigs, outside a uniform sample's
        universe, or (without a somatic rate) off the germline 1/ploidy
        lattice. Used by the posterior engine to zero impossible grid
        points in absent-only mode, where the full prior is otherwise
        only evaluated at the all-zero point.
        """
        import numpy as np

        G = len(grid_values)
        mask = np.ones((self.n_samples, G), dtype=bool)
        for s in range(self.n_samples):
            for gi, v in enumerate(grid_values):
                v = float(v)
                if v == 0.0:
                    continue
                if self.uniform[s]:
                    mask[s, gi] = any(u.contains(v) for u in self.universes[s])
                    continue
                ploidy = self.ploidies[s]
                if ploidy == 0:
                    mask[s, gi] = False
                    continue
                if self.somatic_effective_mutation_rate[s] is not None:
                    continue
                if ploidy is not None and self.heterozygosity is not None:
                    mask[s, gi] = self._is_valid_germline_vaf(s, v)
        return mask

    # ------------------------------------------------------------------
    def compute(self, vafs) -> float:
        """Log prior for a per-sample VAF vector (prior.rs compute)."""
        key = tuple(round(v, 9) for v in vafs)
        if self.is_absent_only and not self.is_all_uniform():
            if any(v > 0.0 for v in vafs):
                full = self._compute_cached(key)
                if full == LOG_ZERO:
                    return LOG_ZERO
                absent = self._compute_cached(tuple(0.0 for _ in vafs))
                return _ln1m(absent)
            return self._compute_cached(key)
        return self._compute_cached(key)

    def prob_absent(self) -> float:
        return self._compute_cached(tuple(0.0 for _ in range(self.n_samples)))

    def _compute_cached(self, key):
        # per-variant HETEROZYGOSITY / SOMATIC_EFFECTIVE_MUTATION_RATE INFO
        # overrides (prior.rs:251-271) are set on the shared per-contig
        # Prior by the caller; they MUST be part of the cache key or an
        # override-free record would serve (and poison) overridden values.
        # Continuous per-record override values would otherwise grow the
        # cache without bound over a genome-scale run — clear it when it
        # gets large (within-variant grid-point reuse, the hot case, only
        # needs the current override's entries).
        key = (key, self.variant_heterozygosity, self.variant_somatic_rate)
        if key not in self._cache:
            if len(self._cache) > 200_000:
                self._cache.clear()
            self._cache[key] = self._calc_prob(list(key[0]), [])
        return self._cache[key]

    # ------------------------------------------------------------------
    def _calc_prob(self, event_vafs, germline_vafs) -> float:
        """prior.rs:298-438."""
        if len(germline_vafs) == len(event_vafs):
            return self._prob_terminal(event_vafs, germline_vafs)

        sample = len(germline_vafs)
        vaf = event_vafs[sample]
        ploidy = self.ploidies[sample]

        if ploidy == 0 and vaf != 0.0:
            return LOG_ZERO
        if self.uniform[sample]:
            if any(u.contains(vaf) for u in self.universes[sample]):
                return self._calc_prob(event_vafs, germline_vafs + [0.0])
            return LOG_ZERO
        if self.somatic_effective_mutation_rate[sample] is not None:
            if ploidy is None:
                raise ValueError("sample with somatic mutation rate but no ploidy")
            probs = []
            for n_alt in range(ploidy + 1):
                gv = n_alt / ploidy if ploidy > 0 else 0.0
                probs.append(self._calc_prob(event_vafs, germline_vafs + [gv]))
            return _ln_sum(probs)
        if ploidy is not None and self.heterozygosity is not None:
            if self._is_valid_germline_vaf(sample, vaf):
                return self._calc_prob(event_vafs, germline_vafs + [vaf])
            return LOG_ZERO
        raise ValueError("not enough info for prior but no universe specified")

    def _prob_terminal(self, event_vafs, germline_vafs) -> float:
        prob = 0.0
        het = self._vartype_het()
        if het is not None:
            population_samples = [
                s
                for s in range(self.n_samples)
                if self.inheritance[s] is None
                and self.ploidies[s] is not None
                and not self.uniform[s]
            ]
            prob += self._prob_population_germline(
                population_samples, germline_vafs, het
            )
        for s in range(self.n_samples):
            if self.uniform[s]:
                continue
            inh = self.inheritance[s]
            if inh is None:
                rate = self._vartype_somatic_rate(s)
                if rate is not None:
                    prob += self._prob_somatic_mutation(
                        rate, self._somatic_vaf(s, event_vafs, germline_vafs)
                    )
            elif inh.kind == "mendelian":
                prob += self._prob_mendelian_inheritance(
                    s, inh.from_samples, event_vafs, germline_vafs
                )
            elif inh.kind == "clonal":
                prob += self._prob_clonal_inheritance(
                    s, inh.from_samples[0], event_vafs, germline_vafs, inh.somatic
                )
            elif inh.kind == "subclonal":
                prob += self._prob_subclonal_inheritance(
                    s, inh.from_samples[0], event_vafs, germline_vafs
                )
        assert prob <= 1e-9, f"prior > 1: {prob}"
        return min(prob, 0.0)

    @staticmethod
    def _somatic_vaf(sample, event_vafs, germline_vafs):
        return event_vafs[sample] - germline_vafs[sample]

    def _prob_somatic_mutation(self, ln_rate, somatic_vaf) -> float:
        """prior.rs:440-456."""
        if abs(somatic_vaf) < 1e-9:
            return _ln1m(ln_rate)
        return ln_rate

    def _prob_clonal_inheritance(
        self, sample, parent, event_vafs, germline_vafs, somatic
    ) -> float:
        """prior.rs:458-512."""
        if abs(germline_vafs[sample] - germline_vafs[parent]) > 1e-9:
            return LOG_ZERO
        rate = self._vartype_somatic_rate(sample)
        sv = self._somatic_vaf(sample, event_vafs, germline_vafs)
        pv = self._somatic_vaf(parent, event_vafs, germline_vafs)
        if somatic:
            if rate is not None:
                if abs(pv) > 1e-9:
                    return 0.0
                return self._prob_somatic_mutation(rate, sv)
            return 0.0 if abs(sv - pv) < 1e-9 else LOG_ZERO
        else:
            if rate is not None:
                return self._prob_somatic_mutation(rate, sv)
            return 0.0

    def _prob_subclonal_inheritance(
        self, sample, parent, event_vafs, germline_vafs
    ) -> float:
        """prior.rs:514-552."""
        if abs(germline_vafs[sample] - germline_vafs[parent]) > 1e-9:
            return LOG_ZERO
        rate = self._vartype_somatic_rate(sample)
        if rate is not None:
            if event_vafs[parent] == 0.0 and germline_vafs[sample] == 0.0:
                return self._prob_somatic_mutation(rate, event_vafs[sample])
            return 0.0
        sv = self._somatic_vaf(sample, event_vafs, germline_vafs)
        pv = self._somatic_vaf(parent, event_vafs, germline_vafs)
        return 0.0 if abs(sv - pv) < 1e-9 else LOG_ZERO

    def _prob_population_germline(
        self, population_samples, germline_vafs, ln_het
    ) -> float:
        """prior.rs:554-582."""
        m = sum(
            round(self.ploidies[s] * germline_vafs[s]) for s in population_samples
        )

        def prob_m(mm):
            return ln_het - math.log(mm)

        if m > 0:
            return prob_m(m)
        n = sum(self.ploidies[s] for s in population_samples)
        if n == 0:
            return 0.0
        return _ln1m(_ln_sum([prob_m(mm) for mm in range(1, n + 1)]))

    def _prob_select_ref_alt(self, ploidy, source_alt, target_alt, target_ref):
        return _ln(
            _hypergeom_pmf(ploidy, source_alt, target_alt + target_ref, target_alt)
        )

    def _prob_mendelian_alt_counts(
        self, source_ploidy, target_ploidy, source_alt, target_alt, germline_rate
    ) -> float:
        """prior.rs:600-678."""

        def after_split(p1, p2):
            out = []
            for a1 in range(0, min(source_alt[0], p1) + 1):
                for a2 in range(0, min(source_alt[1], p2) + 1):
                    if a1 + a2 <= target_alt:
                        r1 = p1 - a1
                        r2 = p2 - a2
                        prob = self._prob_select_ref_alt(
                            source_ploidy[0], source_alt[0], a1, r1
                        ) + self._prob_select_ref_alt(
                            source_ploidy[1], source_alt[1], a2, r2
                        )
                        missing = target_alt - (a1 + a2)
                        out.append(prob + _ln(germline_rate) * missing)
            return out

        def parent_cases(p):
            if p % 2 == 0:
                return [p // 2]
            return [p // 2, p // 2 + 1]

        cases = [
            (p1, p2)
            for p1 in parent_cases(source_ploidy[0])
            for p2 in parent_cases(source_ploidy[1])
        ]
        valid = [c for c in cases if c[0] + c[1] == target_ploidy]
        if not valid:
            raise ValueError(
                f"ploidies of child and parents do not match "
                f"({source_ploidy} => {target_ploidy})"
            )
        probs = []
        for p1, p2 in valid:
            probs.extend(after_split(p1, p2))
        return _ln_sum(probs)

    def _prob_mendelian_inheritance(
        self, child, parents, event_vafs, germline_vafs
    ) -> float:
        """prior.rs:680-712."""

        def ploidy(s):
            return self.ploidies[s]

        def n_alt(s):
            return round(germline_vafs[s] * ploidy(s))

        germline_rate = self._vartype_germline_rate(child)
        if germline_rate is None:
            raise ValueError("no germline mutation rate for child")
        prob = self._prob_mendelian_alt_counts(
            (ploidy(parents[0]), ploidy(parents[1])),
            ploidy(child),
            (n_alt(parents[0]), n_alt(parents[1])),
            n_alt(child),
            germline_rate,
        )
        rate = self._vartype_somatic_rate(child)
        if rate is not None:
            prob += self._prob_somatic_mutation(
                rate, self._somatic_vaf(child, event_vafs, germline_vafs)
            )
        return prob


def build_prior(scenario, contig: str, variant_type: str = "snv") -> Prior:
    """Construct a Prior from a grammar.Scenario for one contig+vartype."""
    names = scenario.sample_names
    ploidies = []
    universes = []
    uniform = []
    germ = []
    som = []
    inh = []
    for n in names:
        s = scenario.samples[n]
        ploidies.append(s.contig_ploidy(contig, scenario.species))
        universes.append(s.contig_universe(contig, scenario.species))
        uniform.append(s.has_uniform_prior())
        germ.append(s.eff_germline_mutation_rate(scenario.species))
        som.append(s.eff_somatic_effective_mutation_rate(scenario.species))
        if s.inheritance:
            (kind, spec), = s.inheritance.items()
            if kind == "mendelian":
                frm = spec["from"]
                inh.append(
                    Inheritance(
                        kind="mendelian",
                        from_samples=(scenario.idx(frm[0]), scenario.idx(frm[1])),
                    )
                )
            elif kind == "clonal":
                inh.append(
                    Inheritance(
                        kind="clonal",
                        from_samples=(scenario.idx(spec["from"]),),
                        somatic=bool(spec.get("somatic", False)),
                    )
                )
            elif kind == "subclonal":
                inh.append(
                    Inheritance(
                        kind="subclonal", from_samples=(scenario.idx(spec["from"]),)
                    )
                )
            else:
                raise ValueError(f"unknown inheritance {kind}")
        else:
            inh.append(None)
    het = scenario.species.heterozygosity if scenario.species else None
    vtf = scenario.variant_type_fractions().get(variant_type)
    return Prior(
        uniform=uniform,
        ploidies=ploidies,
        universes=universes,
        germline_mutation_rate=germ,
        somatic_effective_mutation_rate=som,
        heterozygosity=het,
        inheritance=inh,
        variant_type_fraction=vtf,
    )


from ..errors import InvalidPriorConfigurationError


class InvalidPriorConfiguration(InvalidPriorConfigurationError):
    pass


def check_prior(prior: Prior) -> None:
    """CheckablePrior::check (prior.rs:788-825): fail fast on scenarios
    whose inheritance definitions lack the rates/ploidies they require."""
    for s in range(prior.n_samples):
        inh = prior.inheritance[s]
        if inh is None:
            continue
        parents = inh.from_samples
        if any(prior.ploidies[p] is None for p in parents):
            raise InvalidPriorConfiguration(
                "inheritance defined but parental samples do not have a "
                "ploidy: define ploidy for each sample or the species"
            )
        if inh.kind == "mendelian" and not (
            prior.germline_mutation_rate[s] is not None
            or prior.heterozygosity is not None
        ):
            raise InvalidPriorConfiguration(
                "mendelian inheritance but no germline mutation rate "
                "defined: define germline mutation rate for child samples "
                "or the species"
            )
        if inh.kind == "subclonal" and prior.somatic_effective_mutation_rate[s] is None:
            raise InvalidPriorConfiguration(
                "subclonal inheritance defined but no somatic mutation: "
                "define somatic effective mutation rate for sample that "
                "inherits"
            )
