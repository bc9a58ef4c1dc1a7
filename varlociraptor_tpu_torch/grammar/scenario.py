"""Scenario YAML schema.

Mirrors the reference's ``grammar::Scenario``
(``src/grammar/mod.rs:130-654``): samples (universe, ploidy
incl. per-contig/per-sex maps, contamination, inheritance, mutation rates,
sex), events (formulas), reusable expressions, and species defaults
(heterozygosity, rates, ploidy, variant-type fractions).

Sample order is the sorted-by-name order (the reference uses a BTreeMap), so
sample indices match the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import yaml

from . import formula as fm

DEFAULT_RESOLUTION = 0.01


def _maybe_float(x):
    """YAML 1.1 leaves '1e-6' (no dot) as a string; coerce rates to float."""
    return None if x is None else float(x)


@dataclass
class VariantTypeFraction:
    """grammar/mod.rs:375-425."""

    indel: float = 0.0125
    mnv: float = 0.001
    sv: float = 0.01

    def get(self, variant_type: str) -> float:
        if variant_type in ("insertion", "deletion", "replacement"):
            return self.indel
        if variant_type == "mnv":
            return self.mnv
        if variant_type in ("inversion", "breakend", "duplication"):
            return self.sv
        return 1.0


@dataclass
class Species:
    heterozygosity: float | None = None
    germline_mutation_rate: float | None = None
    somatic_effective_mutation_rate: float | None = None
    variant_type_fractions: VariantTypeFraction = field(default_factory=VariantTypeFraction)
    ploidy: object = None  # int | {contig: int} | {sex: int|{contig:int}}

    def contig_ploidy(self, contig: str, sex: str | None):
        return _resolve_ploidy(self.ploidy, contig, sex)


def _resolve_ploidy(defn, contig, sex=None):
    if defn is None:
        return None
    if isinstance(defn, int):
        return defn
    if isinstance(defn, dict):
        # sex-specific? keys are 'male'/'female'/... when values are int/dict
        keys = set(defn.keys())
        if keys & {"male", "female"} and sex is not None:
            sub = defn.get(sex)
            if sub is None:
                raise ValueError(f"no ploidy for sex {sex}")
            return _resolve_ploidy(sub, contig)
        if keys & {"male", "female"}:
            raise ValueError("sex-specific ploidy but sample has no sex")
        if contig in defn:
            return defn[contig]
        if "all" in defn:
            return defn["all"]
        raise ValueError(f"no ploidy for contig {contig}")
    raise ValueError(f"bad ploidy definition {defn!r}")


@dataclass
class Contamination:
    by: str
    fraction: float


@dataclass
class SampleDef:
    name: str
    contamination: Contamination | None = None
    resolution: float = DEFAULT_RESOLUTION
    universe: object = None  # str | {contig: str}
    somatic_effective_mutation_rate: float | None = None
    germline_mutation_rate: float | None = None
    ploidy: object = None
    inheritance: dict | None = None  # {"mendelian": {"from": [a,b]}} etc.
    sex: str | None = None

    def has_uniform_prior(self) -> bool:
        return self.universe is not None

    def contig_ploidy(self, contig: str, species: Species | None):
        if self.ploidy is not None:
            return _resolve_ploidy(self.ploidy, contig)
        if species is not None:
            return species.contig_ploidy(contig, self.sex)
        return None

    def eff_germline_mutation_rate(self, species):
        if self.germline_mutation_rate is not None:
            return self.germline_mutation_rate
        return species.germline_mutation_rate if species else None

    def eff_somatic_effective_mutation_rate(self, species):
        if self.somatic_effective_mutation_rate is not None:
            return self.somatic_effective_mutation_rate
        return species.somatic_effective_mutation_rate if species else None

    def contig_universe(self, contig: str, species: Species | None):
        """grammar/mod.rs:503-579: explicit universe, or ploidy-derived."""
        if self.universe is not None:
            defn = self.universe
            if isinstance(defn, dict):
                defn = defn.get(contig, defn.get("all"))
                if defn is None:
                    raise ValueError(f"universe for contig {contig} not found")
            return fm.parse_universe(defn)
        ploidy = self.contig_ploidy(contig, species)
        # SAMPLE-level rate only (grammar/mod.rs:537): a species-level rate
        # does NOT switch the ploidy-derived universe to continuous ranges
        has_somatic = self.somatic_effective_mutation_rate is not None
        if ploidy is not None and not has_somatic:
            pts = (
                [i / ploidy for i in range(ploidy + 1)] if ploidy > 0 else [0.0]
            )
            return [fm.VAFSpectrum.from_set(pts)]
        if ploidy is not None and has_somatic:
            pts = (
                [i / ploidy for i in range(ploidy + 1)] if ploidy > 0 else [0.0]
            )
            out = []
            for a, b in zip(pts[:-1], pts[1:]):
                out.append(
                    fm.VAFSpectrum.range(
                        fm.VAFRange(a, b, left_exclusive=True, right_exclusive=True)
                    )
                )
            out.append(fm.VAFSpectrum.from_set(pts))
            return out
        if ploidy is None and has_somatic:
            return [fm.VAFSpectrum.range(fm.VAFRange(0.0, 1.0))]
        raise ValueError(
            f"sample {self.name} needs universe, ploidy or somatic mutation rate"
        )


_KNOWN_TOP_KEYS = {"samples", "events", "expressions", "species"}
_KNOWN_SAMPLE_KEYS = {
    "contamination", "resolution", "universe",
    "somatic_effective_mutation_rate", "somatic-effective-mutation-rate",
    "germline_mutation_rate", "germline-mutation-rate",
    "ploidy", "inheritance", "sex",
}
_KNOWN_SPECIES_KEYS = {
    "heterozygosity", "germline-mutation-rate", "germline_mutation_rate",
    "somatic-effective-mutation-rate", "somatic_effective_mutation_rate",
    "variant-fractions", "variant_fractions", "ploidy", "genome-size",
    "genome_size",
}


def _reject_unknown(keys, known, where):
    """serde's deny_unknown_fields (grammar/mod.rs:131,347,472): typos in
    scenario YAML must fail loudly, not silently change the model."""
    unknown = [k for k in keys if k not in known]
    if unknown:
        raise ValueError(
            f"unknown field(s) {unknown} in scenario {where}; "
            f"allowed: {sorted(known)}"
        )


class Scenario:
    def __init__(self, doc: dict):
        self.doc = doc
        _reject_unknown(doc.keys(), _KNOWN_TOP_KEYS, "document")
        if doc.get("species"):
            _reject_unknown(
                doc["species"].keys(), _KNOWN_SPECIES_KEYS, "species"
            )
        for name, s in doc["samples"].items():
            _reject_unknown(
                (s or {}).keys(), _KNOWN_SAMPLE_KEYS, f"sample {name!r}"
            )
            if (s or {}).get("contamination"):
                _reject_unknown(
                    s["contamination"].keys(),
                    {"by", "fraction"},
                    f"sample {name!r} contamination",
                )
        self.species = self._parse_species(doc.get("species"))
        self.samples: dict[str, SampleDef] = {}
        for name in sorted(doc["samples"].keys()):
            s = doc["samples"][name] or {}
            contamination = None
            if s.get("contamination"):
                contamination = Contamination(
                    by=s["contamination"]["by"], fraction=float(s["contamination"]["fraction"])
                )
            self.samples[name] = SampleDef(
                name=name,
                contamination=contamination,
                resolution=float(s.get("resolution", DEFAULT_RESOLUTION)),
                universe=s.get("universe"),
                somatic_effective_mutation_rate=_maybe_float(
                    s.get("somatic_effective_mutation_rate")
                ),
                germline_mutation_rate=_maybe_float(s.get("germline_mutation_rate")),
                ploidy=s.get("ploidy"),
                inheritance=s.get("inheritance"),
                sex=s.get("sex"),
            )
        # kebab-case aliases (reference serde renames)
        for name, s in doc["samples"].items():
            s = s or {}
            sd = self.samples[name]
            if "somatic-effective-mutation-rate" in s:
                sd.somatic_effective_mutation_rate = _maybe_float(
                    s["somatic-effective-mutation-rate"]
                )
            if "germline-mutation-rate" in s:
                sd.germline_mutation_rate = _maybe_float(s["germline-mutation-rate"])

        self.sample_names = list(self.samples.keys())  # sorted
        self.sample_idx = {n: i for i, n in enumerate(self.sample_names)}

        self.event_formulas: dict[str, object] = {}
        for name, text in doc.get("events", {}).items():
            self.event_formulas[name] = fm.parse_formula(text)

        self.expressions: dict[str, object] = {}
        for name, text in doc.get("expressions", {}).items():
            self.expressions[name] = fm.parse_formula(text)
        # register events as expressions (grammar/mod.rs:152-166)
        for name, f in self.event_formulas.items():
            self.expressions.setdefault(name, f)
        self.expressions.setdefault("absent", self.absent_formula())

    # ------------------------------------------------------------------
    @staticmethod
    def _parse_species(doc):
        if not doc:
            return None
        vtf = VariantTypeFraction()
        def both(kebab):
            # both spellings are admitted by the strict-key check, so both
            # must be READ (admitting a key but ignoring its value would be
            # a silent model change)
            return doc.get(kebab, doc.get(kebab.replace("-", "_")))

        if both("variant-fractions"):
            vf = both("variant-fractions")
            vtf = VariantTypeFraction(
                indel=vf.get("indel", 0.0125),
                mnv=vf.get("mnv", 0.001),
                sv=vf.get("sv", 0.01),
            )
        return Species(
            heterozygosity=_maybe_float(doc.get("heterozygosity")),
            germline_mutation_rate=_maybe_float(both("germline-mutation-rate")),
            somatic_effective_mutation_rate=_maybe_float(
                both("somatic-effective-mutation-rate")
            ),
            variant_type_fractions=vtf,
            ploidy=doc.get("ploidy"),
        )

    @classmethod
    def from_path(cls, path):
        with open(path) as f:
            return cls(yaml.safe_load(f))

    @classmethod
    def from_yaml(cls, text: str):
        return cls(yaml.safe_load(text))

    # ------------------------------------------------------------------
    def absent_formula(self):
        return fm.Conjunction(
            tuple(
                fm.Atom(sample=n, vafs=fm.VAFSpectrum.singleton(0.0))
                for n in self.sample_names
            )
        )

    def idx(self, sample: str) -> int:
        return self.sample_idx[sample]

    def universe_fn(self, contig: str):
        def fn(sample_name: str):
            if sample_name not in self.samples:
                raise ValueError(f"invalid sample name {sample_name}")
            return self.samples[sample_name].contig_universe(contig, self.species)

        return fn

    def normalized_events(self, contig: str) -> dict[str, object]:
        """Event name -> normalized formula for the contig."""
        ufn = self.universe_fn(contig)
        return {
            name: fm.normalize(f, self.expressions, ufn)
            for name, f in self.event_formulas.items()
        }

    def variant_type_fractions(self) -> VariantTypeFraction:
        if self.species:
            return self.species.variant_type_fractions
        return VariantTypeFraction()

    def validate(self, contig: str):
        """Error if one event is exactly the disjunction of two others
        (grammar/mod.rs:224-278). Events are compared via canonical merged
        branch sets (the reference compares BDD-simplified formulas)."""
        import itertools

        from .compiler import compile_event

        sets = {}
        for name, f in self.event_formulas.items():
            if name == "absent":
                continue
            ev = compile_event(name, f, self, contig)
            sets[name] = _merged_branch_set(ev.branches)
        names = sorted(sets)
        by_set = {}
        for name in names:
            by_set.setdefault(sets[name], []).append(name)
        for n1, n2 in itertools.combinations(names, 2):
            union = _merged_branch_set(
                tuple(b for n in (n1, n2) for b in _branch_set_to_branches(sets[n]))
            )
            if union in by_set and not set(by_set[union]) <= {n1, n2}:
                raise OverlappingEventsError(
                    f"event {by_set[union]} is the disjunction of "
                    f"{n1!r} and {n2!r}; overlapping events are not allowed"
                )


from ..errors import OverlappingEventsError as _OEE


class OverlappingEventsError(_OEE):
    pass


def _merged_branch_set(branches):
    """Canonical frozenset of branch spectra, with single-sample spectrum
    unions applied to fixpoint (mirrors the BDD + merge_atoms pipeline)."""
    from ..ops.event_program import BranchSpec

    items = {
        (br.spectra, br.snv_gates, br.lfcs) for br in branches
    }
    changed = True
    while changed:
        changed = False
        for a, b in itertools_combinations(items):
            if a[1] != b[1] or a[2] != b[2]:
                continue
            diff = [
                i for i, (x, y) in enumerate(zip(a[0], b[0])) if x != y
            ]
            if len(diff) != 1:
                continue
            i = diff[0]
            from .compiler import _spec_to_spectrum, _spectrum_to_spec

            u = fm._try_union_spectra(
                _spec_to_spectrum(a[0][i]), _spec_to_spectrum(b[0][i])
            )
            if u is None:
                continue
            spectra = list(a[0])
            spectra[i] = _spectrum_to_spec(u)
            items.discard(a)
            items.discard(b)
            items.add((tuple(spectra), a[1], a[2]))
            changed = True
            break
    return frozenset(items)


def _branch_set_to_branches(bset):
    from ..ops.event_program import BranchSpec

    return [
        BranchSpec(spectra=s, snv_gates=g, lfcs=l) for (s, g, l) in bset
    ]


def itertools_combinations(items):
    import itertools

    return itertools.combinations(list(items), 2)


def tumor_normal_scenario(purity: float) -> Scenario:
    """The built-in tumor-normal scenario synthesized by the reference CLI
    (cli.rs:1151-1167)."""
    doc = {
        "samples": {
            "tumor": {
                "resolution": 0.01,
                "contamination": {"by": "normal", "fraction": 1.0 - purity},
                "universe": "[0.0,1.0]",
            },
            "normal": {
                "resolution": 0.1,
                "universe": "[0.0,0.5[ | 0.5 | 1.0",
            },
        },
        "events": {
            "somatic_tumor": "tumor:]0.0,1.0] & normal:0.0",
            "somatic_normal": "tumor:]0.0,1.0] & normal:]0.0,0.5[",
            "germline_het": "tumor:]0.0,1.0] & normal:0.5",
            "germline_hom": "tumor:]0.0,1.0] & normal:1.0",
        },
    }
    return Scenario(doc)
