"""Scenario -> tensor event program compiler.

Builds the VAF tree per event (mirroring
``src/grammar/vaftree.rs:167-305``: disjunction = branching,
conjunction = chaining at leaves, missing samples auto-filled with their
contig universe) and flattens root-to-leaf paths into
``ops.event_program.EventSpec`` branches for the grid posterior engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.event_program import (
    BranchSpec,
    EventSpec,
    LfcConstraint,
    SnvGate,
    SpectrumSpec,
)
from . import formula as fm
from .scenario import Scenario

# ---------------------------------------------------------------------------
# VAF tree (mirrors vaftree.rs)
# ---------------------------------------------------------------------------


@dataclass
class Node:
    kind: str  # sample | variant | lfc | true | false
    sample: int | None = None
    vafs: object = None  # fm.VAFSpectrum
    positive: bool = True
    refbase: str = "N"
    altbase: str = "N"
    sample_a: int | None = None
    sample_b: int | None = None
    op: str = "=="
    value: float = 0.0
    children: list = field(default_factory=list)

    def leafs(self):
        if not self.children:
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leafs())
        return out


def _clone(node: Node) -> Node:
    return Node(
        kind=node.kind,
        sample=node.sample,
        vafs=node.vafs,
        positive=node.positive,
        refbase=node.refbase,
        altbase=node.altbase,
        sample_a=node.sample_a,
        sample_b=node.sample_b,
        op=node.op,
        value=node.value,
        children=[_clone(c) for c in node.children],
    )


def build_tree(formula, scenario: Scenario) -> list[Node]:
    """vaftree.rs:173-247."""
    if isinstance(formula, fm.Atom):
        return [Node(kind="sample", sample=scenario.idx(formula.sample), vafs=formula.vafs)]
    if isinstance(formula, fm.Disjunction):
        out = []
        for o in formula.operands:
            out.extend(build_tree(o, scenario))
        return out
    if isinstance(formula, fm.Conjunction):
        # sort disjunctions to the end (vaftree.rs:196-203)
        operands = sorted(
            formula.operands,
            key=lambda o: 1 if isinstance(o, fm.Disjunction) else 0,
        )
        roots = build_tree(operands[0], scenario)
        for operand in operands[1:]:
            subtrees = build_tree(operand, scenario)
            for subtree in roots:
                for leaf in subtree.leafs():
                    leaf.children = [_clone(st) for st in subtrees]
        return roots
    if isinstance(formula, fm.Variant):
        return [
            Node(
                kind="variant",
                positive=formula.positive,
                refbase=formula.refbase,
                altbase=formula.altbase,
            )
        ]
    if isinstance(formula, fm.Lfc):
        return [
            Node(
                kind="lfc",
                sample_a=scenario.idx(formula.sample_a),
                sample_b=scenario.idx(formula.sample_b),
                op=formula.op,
                value=formula.value,
            )
        ]
    if isinstance(formula, fm.FalseLit):
        return [Node(kind="false")]
    if isinstance(formula, fm.TrueLit):
        return [Node(kind="true")]
    raise TypeError(f"cannot build tree from {formula}")


def add_missing_samples(node: Node, seen: set, scenario: Scenario, contig: str):
    """vaftree.rs:250-296."""
    if node.kind == "false":
        return
    if node.kind == "sample":
        seen.add(node.sample)
    if not node.children:
        for name in scenario.sample_names:
            idx = scenario.idx(name)
            if idx not in seen:
                seen.add(idx)
                universe = scenario.samples[name].contig_universe(
                    contig, scenario.species
                )
                node.children = [
                    Node(kind="sample", sample=idx, vafs=vafs) for vafs in universe
                ]
                add_missing_samples(node, seen, scenario, contig)
                break
    else:
        if len(node.children) > 1:
            for child in node.children[1:]:
                add_missing_samples(child, set(seen), scenario, contig)
        add_missing_samples(node.children[0], seen, scenario, contig)


# ---------------------------------------------------------------------------
# flatten to branches
# ---------------------------------------------------------------------------


def _spectrum_to_spec(vafs: fm.VAFSpectrum) -> SpectrumSpec:
    if vafs.is_set:
        return SpectrumSpec.from_set(vafs.set_values)
    r = vafs.range_value
    return SpectrumSpec.from_range(r.start, r.end, r.left_exclusive, r.right_exclusive)


def _spec_to_spectrum(spec: SpectrumSpec) -> fm.VAFSpectrum:
    if spec.is_set:
        return fm.VAFSpectrum.from_set(spec.values)
    return fm.VAFSpectrum.range(
        fm.VAFRange(spec.start, spec.end, spec.left_exclusive, spec.right_exclusive)
    )


def flatten_tree(roots: list[Node], n_samples: int) -> list[BranchSpec]:
    branches = []

    def walk(node: Node, spectra: dict, gates: list, lfcs: list):
        spectra = dict(spectra)
        gates = list(gates)
        lfcs = list(lfcs)
        if node.kind == "false":
            return
        if node.kind == "sample":
            if node.sample in spectra:
                # same sample constrained twice on one path (possible with
                # nested disjunctions the atom-merge cannot collapse):
                # conjunction semantics = spectrum intersection
                merged = fm._intersect_spectra(
                    _spec_to_spectrum(spectra[node.sample]), node.vafs
                )
                if merged.is_empty:
                    return  # path contributes probability zero
                spectra[node.sample] = _spectrum_to_spec(merged)
            else:
                spectra[node.sample] = _spectrum_to_spec(node.vafs)
        elif node.kind == "variant":
            gates.append(
                SnvGate(
                    positive=node.positive,
                    ref_bases=frozenset(fm.IUPAC[node.refbase]),
                    alt_bases=frozenset(fm.IUPAC[node.altbase]),
                )
            )
        elif node.kind == "lfc":
            lfcs.append(
                LfcConstraint(
                    sample_a=node.sample_a,
                    sample_b=node.sample_b,
                    op=node.op,
                    value=node.value,
                )
            )
        if not node.children:
            assert set(spectra.keys()) == set(range(n_samples)), (
                f"path missing samples: have {sorted(spectra)}, need {n_samples}"
            )
            branches.append(
                BranchSpec(
                    spectra=tuple(spectra[i] for i in range(n_samples)),
                    snv_gates=tuple(gates),
                    lfcs=tuple(lfcs),
                )
            )
            return
        for child in node.children:
            walk(child, spectra, gates, lfcs)

    for root in roots:
        walk(root, {}, [], [])
    return branches


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def compile_event(
    name: str, formula, scenario: Scenario, contig: str, is_artifact=False
) -> EventSpec:
    ufn = scenario.universe_fn(contig)
    normalized = fm.normalize(formula, scenario.expressions, ufn)
    if isinstance(normalized, fm.FalseLit):
        return EventSpec(name=name, branches=(), is_artifact=is_artifact)
    roots = build_tree(normalized, scenario)
    for node in roots:
        add_missing_samples(node, set(), scenario, contig)
    branches = flatten_tree(roots, len(scenario.sample_names))
    return EventSpec(name=name, branches=tuple(branches), is_artifact=is_artifact)


def compile_scenario_events(
    scenario: Scenario, contig: str, with_artifact_twins: bool = True
):
    """Build the full event universe for calling (calling.rs:632-718):
    'absent' + each scenario event + (optionally) one biased twin per event.

    Returns (events, grid_points): events ordered [absent, e1.., artifact-e1..]
    and the set of discrete VAFs referenced (for grid construction).
    """
    scenario.validate(contig)
    events = []
    # absent event
    events.append(
        compile_event("absent", scenario.expressions["absent"], scenario, contig)
    )
    for name, f in scenario.event_formulas.items():
        if name == "absent":
            continue
        events.append(compile_event(name, f, scenario, contig))
    if with_artifact_twins:
        for name, f in list(scenario.event_formulas.items()):
            if name == "absent":
                continue
            ev = compile_event(
                f"artifact_{name}", f, scenario, contig, is_artifact=True
            )
            events.append(ev)

    grid_points = set()
    for ev in events:
        for br in ev.branches:
            for sp in br.spectra:
                if sp.is_set:
                    grid_points.update(sp.values)
                else:
                    grid_points.update([sp.start, sp.end])
    return events, sorted(grid_points)
