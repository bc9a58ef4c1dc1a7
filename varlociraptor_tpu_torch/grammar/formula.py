"""Scenario formula language: parser + symbolic algebra.

Re-implements the reference's pest PEG grammar
(``src/grammar/formula.pest``) with a recursive-descent
parser, and the normalization pipeline (``formula.rs:473-485``):
expand expressions -> push negations to atoms (complementing VAF spectra
against the sample universe, ``formula.rs:717-865``) -> flatten/simplify ->
merge same-sample atoms (intersection in conjunctions / greedy union in
disjunctions, ``formula.rs:575-689``) -> strip false.

VAF spectra/interval algebra mirrors ``formula.rs:1018-1302``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# IUPAC
# ---------------------------------------------------------------------------

IUPAC = {
    "A": {"A"},
    "C": {"C"},
    "G": {"G"},
    "T": {"T"},
    "R": {"A", "G"},
    "Y": {"C", "T"},
    "S": {"G", "C"},
    "W": {"A", "T"},
    "K": {"G", "T"},
    "M": {"A", "C"},
    "B": {"C", "G", "T"},
    "D": {"A", "G", "T"},
    "H": {"A", "C", "T"},
    "V": {"A", "C", "G"},
    "N": {"A", "C", "G", "T"},
}


# ---------------------------------------------------------------------------
# VAF spectra
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class VAFRange:
    start: float
    end: float
    left_exclusive: bool = False
    right_exclusive: bool = False

    @property
    def is_empty(self):
        return self.start == self.end and (self.left_exclusive or self.right_exclusive)

    @property
    def is_singleton(self):
        return self.start == self.end and not (self.left_exclusive or self.right_exclusive)

    def contains(self, vaf: float) -> bool:
        lo = vaf > self.start if self.left_exclusive else vaf >= self.start
        hi = vaf < self.end if self.right_exclusive else vaf <= self.end
        return lo and hi

    def split_at(self, vaf: float):
        """(left, right) spectra, None where empty (formula.rs:1106-1135).

        A degenerate piece (start == end) survives as a SINGLETON set
        unless its left bound is exclusive and the parent's right bound is
        exclusive — the reference's to_spectrum rule. This is what makes
        e.g. the complement of [0.0,1.0[ against universe [0.0,1.0] come
        out as {1.0} instead of vanishing (the right piece ]1.0,1.0] is
        degenerate but the parent end is inclusive)."""
        assert self.contains(vaf)

        def to_spec(start, end, lex, rex):
            if start == end:
                if not (lex and self.right_exclusive):
                    return VAFSpectrum.from_set([start])
                return None
            return VAFSpectrum.range(VAFRange(start, end, lex, rex))

        return (
            to_spec(self.start, vaf, self.left_exclusive, True),
            to_spec(vaf, self.end, True, self.right_exclusive),
        )

    def overlap(self, other: "VAFRange") -> str:
        """one of contained/contains/end/start/equal/none
        (formula.rs:1137-1170, incl. the exclusivity tie-breaks: at equal
        boundary values an exclusive bound is strictly inside an
        inclusive one)."""
        if self == other:
            return "equal"
        s_right_of = (
            self.start >= other.start
            if (self.left_exclusive and not other.left_exclusive)
            else self.start > other.start
        )
        e_left_of = (
            self.end <= other.end
            if (self.right_exclusive and not other.right_exclusive)
            else self.end < other.end
        )
        if (
            (self.end < other.start or self.start > other.end)
            or (
                self.end <= other.start
                and (self.right_exclusive or other.left_exclusive)
            )
            or (
                self.start >= other.end
                and (self.left_exclusive or other.right_exclusive)
            )
        ):
            return "none"
        if s_right_of and e_left_of:
            return "contained"
        if s_right_of and not e_left_of:
            return "start"
        if not s_right_of and e_left_of:
            return "end"
        return "contains"

    def intersect(self, other: "VAFRange") -> "VAFRange":
        """formula.rs:1234-1262: at equal boundary values the EXCLUSIVE
        bound wins (OR of the exclusivities)."""
        if self.overlap(other) == "none":
            return VAFRange(0.0, 0.0, True, True)
        if self.start > other.start:
            start, lex = self.start, self.left_exclusive
        elif self.start < other.start:
            start, lex = other.start, other.left_exclusive
        else:
            start = self.start
            lex = self.left_exclusive or other.left_exclusive
        if self.end < other.end:
            end, rex = self.end, self.right_exclusive
        elif self.end > other.end:
            end, rex = other.end, other.right_exclusive
        else:
            end = self.end
            rex = self.right_exclusive or other.right_exclusive
        return VAFRange(start, end, lex, rex)


@dataclass(frozen=True)
class VAFSpectrum:
    """Set(vafs) or Range."""

    set_values: tuple | None = None
    range_value: VAFRange | None = None

    @classmethod
    def from_set(cls, values):
        return cls(set_values=tuple(sorted(set(float(v) for v in values))))

    @classmethod
    def range(cls, r: VAFRange):
        return cls(range_value=r)

    @classmethod
    def singleton(cls, v: float):
        return cls.from_set([v])

    @classmethod
    def empty(cls):
        return cls.from_set([])

    @property
    def is_set(self):
        return self.set_values is not None

    @property
    def is_empty(self):
        if self.is_set:
            return len(self.set_values) == 0
        return self.range_value.is_empty

    def contains(self, vaf: float) -> bool:
        if self.is_set:
            return any(abs(v - vaf) < 1e-9 for v in self.set_values)
        return self.range_value.contains(vaf)

    def min_vaf(self):
        return min(self.set_values) if self.is_set else self.range_value.start

    def __str__(self):
        if self.is_set:
            if len(self.set_values) == 1:
                return f"{self.set_values[0]}"
            return "{" + ",".join(str(v) for v in self.set_values) + "}"
        r = self.range_value
        lb = "]" if r.left_exclusive else "["
        rb = "[" if r.right_exclusive else "]"
        return f"{lb}{r.start},{r.end}{rb}"


# ---------------------------------------------------------------------------
# Formula AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Atom:
    sample: str
    vafs: VAFSpectrum


@dataclass(frozen=True)
class Variant:
    positive: bool
    refbase: str
    altbase: str


@dataclass(frozen=True)
class Lfc:
    sample_a: str
    sample_b: str
    op: str
    value: float


@dataclass(frozen=True)
class Cmp:
    """sample-vs-sample VAF comparison (desugars to l2fc against 0)."""

    sample_a: str
    sample_b: str
    op: str


@dataclass(frozen=True)
class Expression:
    identifier: str
    negated: bool = False


@dataclass(frozen=True)
class TrueLit:
    pass


@dataclass(frozen=True)
class FalseLit:
    pass


@dataclass(frozen=True)
class Conjunction:
    operands: tuple


@dataclass(frozen=True)
class Disjunction:
    operands: tuple


@dataclass(frozen=True)
class Negation:
    operand: object


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

# idents may contain digits/dots/dashes (e.g. sample "18_D"), so numbers are
# lexed as idents and converted contextually (the pest grammar disambiguates
# by rule context; we do the same at parse time).
_TOKEN_RE = re.compile(
    r"\s*(?:(?P<lfc>l2fc\()|(?P<cmpop><=|>=|==|!=|<|>)|(?P<punct>[()&|!:,{}$])"
    r"|(?P<bound>[\[\]])|(?P<ident>-?[A-Za-z0-9_.\-]+(?:[eE][+-]\d+)?))"
)


class _Tokens:
    def __init__(self, text):
        self.text = text
        self.tokens = []
        pos = 0
        # strip comments
        text = re.sub(r"/\*.*?\*/", " ", text)
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip() == "":
                    break
                raise ValueError(f"cannot tokenize formula at: {text[pos:]!r}")
            for kind in ("lfc", "cmpop", "punct", "bound", "ident"):
                if m.group(kind) is not None:
                    self.tokens.append((kind, m.group(kind)))
                    break
            pos = m.end()
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind=None, value=None):
        k, v = self.next()
        if (kind and k != kind) or (value and v != value):
            raise ValueError(f"expected {kind}/{value}, got {k}/{v} in {self.text!r}")
        return v

    def expect_number(self) -> float:
        k, v = self.next()
        try:
            return float(v)
        except (TypeError, ValueError):
            raise ValueError(f"expected number, got {k}/{v} in {self.text!r}")

    def peek_is_number(self) -> bool:
        k, v = self.peek()
        if k != "ident":
            return False
        try:
            float(v)
            return True
        except (TypeError, ValueError):
            return False

    @property
    def done(self):
        return self.i >= len(self.tokens)


def _parse_vafdef_after_ident(toks: _Tokens, name: str):
    """Parse the spectrum after `name:`."""
    k, v = toks.peek()
    if k == "bound":
        lb = toks.next()[1]
        a = toks.expect_number()
        toks.expect("punct", ",")
        b = toks.expect_number()
        rb = toks.expect("bound")
        return Atom(
            sample=name,
            vafs=VAFSpectrum.range(
                VAFRange(a, b, left_exclusive=lb == "]", right_exclusive=rb == "[")
            ),
        )
    if k == "punct" and v == "{":
        toks.next()
        vals = [toks.expect_number()]
        while toks.peek() == ("punct", ","):
            toks.next()
            vals.append(toks.expect_number())
        toks.expect("punct", "}")
        return Atom(sample=name, vafs=VAFSpectrum.from_set(vals))
    if toks.peek_is_number():
        return Atom(sample=name, vafs=VAFSpectrum.singleton(toks.expect_number()))
    raise ValueError(f"bad VAF definition after {name}:")


def _parse_primary(toks: _Tokens):
    k, v = toks.peek()
    if k == "lfc":
        toks.next()
        a = toks.expect("ident")
        toks.expect("punct", ",")
        b = toks.expect("ident")
        toks.expect("punct", ")")
        op = toks.expect("cmpop")
        val = toks.expect_number()
        return Lfc(sample_a=a, sample_b=b, op=op, value=val)
    if k == "punct" and v == "(":
        toks.next()
        inner = _parse_expr(toks)
        toks.expect("punct", ")")
        return inner
    if k == "punct" and v == "!":
        toks.next()
        return Negation(operand=_parse_primary(toks))
    if k == "punct" and v == "$":
        toks.next()
        return Expression(identifier=toks.expect("ident"))
    if k == "ident":
        name = toks.next()[1]
        nk, nv = toks.peek()
        if nk == "punct" and nv == ":":
            toks.next()
            return _parse_vafdef_after_ident(toks, name)
        if nk == "cmpop":
            # variant selector `R>T` or sample cmp `a < b`
            op = toks.next()[1]
            other = toks.expect("ident")
            if (
                op == ">"
                and len(name) == 1
                and name in IUPAC
                and len(other) == 1
                and other in IUPAC
            ):
                return Variant(positive=True, refbase=name, altbase=other)
            return Cmp(sample_a=name, sample_b=other, op=op)
        if name == "false":
            return FalseLit()
        if name == "true":
            return TrueLit()
        raise ValueError(f"unexpected bare identifier {name!r}")
    raise ValueError(f"unexpected token {k}/{v}")


def _parse_expr(toks: _Tokens):
    first = _parse_primary(toks)
    k, v = toks.peek()
    if k == "punct" and v == "&":
        ops = [first]
        while toks.peek() == ("punct", "&"):
            toks.next()
            ops.append(_parse_primary(toks))
        return Conjunction(operands=tuple(ops))
    if k == "punct" and v == "|":
        ops = [first]
        while toks.peek() == ("punct", "|"):
            toks.next()
            ops.append(_parse_primary(toks))
        return Disjunction(operands=tuple(ops))
    return first


def parse_formula(text):
    """Parse a formula string into the AST."""
    if isinstance(text, bool):
        return TrueLit() if text else FalseLit()
    toks = _Tokens(str(text))
    out = _parse_expr(toks)
    if not toks.done:
        raise ValueError(f"trailing tokens in formula {text!r}")
    return out


def parse_universe(text: str) -> list[VAFSpectrum]:
    """Parse a universe definition: `vafdef | vafdef | ...`."""
    specs = []
    for part in str(text).split("|"):
        part = part.strip()
        toks = _Tokens(part)
        atom = _parse_vafdef_after_ident(toks, "_")
        if not toks.done:
            raise ValueError(f"trailing tokens in universe {part!r}")
        specs.append(atom.vafs)
    return specs


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def expand_expressions(f, expressions: dict):
    if isinstance(f, Conjunction):
        return Conjunction(tuple(expand_expressions(o, expressions) for o in f.operands))
    if isinstance(f, Disjunction):
        return Disjunction(tuple(expand_expressions(o, expressions) for o in f.operands))
    if isinstance(f, Negation):
        return Negation(expand_expressions(f.operand, expressions))
    if isinstance(f, Expression):
        if f.identifier not in expressions:
            raise ValueError(f"undefined expression ${f.identifier}")
        inner = expressions[f.identifier]
        inner = expand_expressions(inner, expressions)
        return Negation(inner) if f.negated else inner
    if isinstance(f, Cmp):
        # a == b -> l2fc(a,b) == 0; a < b -> l2fc(a,b) < 0, etc.
        return Lfc(sample_a=f.sample_a, sample_b=f.sample_b, op=f.op, value=0.0)
    return f


def negate_spectrum_against_universe(vafs: VAFSpectrum, universe: list[VAFSpectrum]):
    """Complement a spectrum against the sample universe
    (formula.rs:759-855). Returns list of spectra (disjunction)."""
    out = []
    if vafs.is_set:
        stack = list(universe)
        while stack:
            u = stack.pop(0)
            if u.is_set:
                diff = [x for x in u.set_values if not vafs.contains(x)]
                if diff:
                    out.append(VAFSpectrum.from_set(diff))
            else:
                ur = u.range_value
                consumed = False
                for v in vafs.set_values:
                    if ur.contains(v):
                        left, right = ur.split_at(v)
                        if right is not None:
                            stack.append(right)
                        if left is not None and not (
                            left.is_set and left.set_values == (v,)
                        ):
                            # a degenerate left piece IS the negated point
                            # itself — it must not enter the complement
                            out.append(left)
                        consumed = True
                        break
                if not consumed:
                    out.append(u)
    else:
        r = vafs.range_value
        for u in universe:
            if u.is_set:
                s = [x for x in u.set_values if not r.contains(x)]
                if s:
                    out.append(VAFSpectrum.from_set(s))
            else:
                ur = u.range_value
                ov = r.overlap(ur)
                if ov == "equal":
                    pass
                elif ov == "contained":
                    left = ur.split_at(r.start)[0]
                    right = ur.split_at(r.end)[1]
                    if left is not None:
                        out.append(left)
                    if right is not None:
                        out.append(right)
                elif ov == "end":
                    right = ur.split_at(r.end)[1]
                    if right is not None:
                        out.append(right)
                elif ov == "start":
                    left = ur.split_at(r.start)[0]
                    if left is not None:
                        out.append(left)
                elif ov == "none":
                    out.append(u)
                elif ov == "contains":
                    pass
    return out


_NEG_OP = {"==": "!=", "!=": "==", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}


def negate(f, universe_fn):
    """Push a negation one level down (formula.rs:713-865).
    universe_fn(sample) -> list[VAFSpectrum]."""
    if isinstance(f, FalseLit):
        return TrueLit()
    if isinstance(f, TrueLit):
        return FalseLit()
    if isinstance(f, Conjunction):
        return Disjunction(tuple(negate(o, universe_fn) for o in f.operands))
    if isinstance(f, Disjunction):
        return Conjunction(tuple(negate(o, universe_fn) for o in f.operands))
    if isinstance(f, Negation):
        return f.operand
    if isinstance(f, Variant):
        return Variant(positive=not f.positive, refbase=f.refbase, altbase=f.altbase)
    if isinstance(f, Lfc):
        return Lfc(sample_a=f.sample_a, sample_b=f.sample_b, op=_NEG_OP[f.op], value=f.value)
    if isinstance(f, Atom):
        spectra = negate_spectrum_against_universe(f.vafs, universe_fn(f.sample))
        if not spectra:
            return Atom(sample=f.sample, vafs=VAFSpectrum.empty())
        if len(spectra) == 1:
            return Atom(sample=f.sample, vafs=spectra[0])
        return Disjunction(tuple(Atom(sample=f.sample, vafs=sp) for sp in spectra))
    raise TypeError(f"cannot negate {f}")


def apply_negations(f, universe_fn):
    if isinstance(f, Negation):
        return apply_negations(negate(f.operand, universe_fn), universe_fn)
    if isinstance(f, Conjunction):
        return Conjunction(tuple(apply_negations(o, universe_fn) for o in f.operands))
    if isinstance(f, Disjunction):
        return Disjunction(tuple(apply_negations(o, universe_fn) for o in f.operands))
    return f


def flatten(f):
    """Flatten nested conjunctions/disjunctions, apply boolean identities."""
    if isinstance(f, Conjunction):
        ops = []
        for o in f.operands:
            o = flatten(o)
            if isinstance(o, Conjunction):
                ops.extend(o.operands)
            elif isinstance(o, TrueLit):
                continue
            elif isinstance(o, FalseLit):
                return FalseLit()
            else:
                ops.append(o)
        # dedupe preserving order
        seen, uniq = set(), []
        for o in ops:
            if o not in seen:
                seen.add(o)
                uniq.append(o)
        if not uniq:
            return TrueLit()
        if len(uniq) == 1:
            return uniq[0]
        return Conjunction(tuple(uniq))
    if isinstance(f, Disjunction):
        ops = []
        for o in f.operands:
            o = flatten(o)
            if isinstance(o, Disjunction):
                ops.extend(o.operands)
            elif isinstance(o, FalseLit):
                continue
            elif isinstance(o, TrueLit):
                return TrueLit()
            else:
                ops.append(o)
        seen, uniq = set(), []
        for o in ops:
            if o not in seen:
                seen.add(o)
                uniq.append(o)
        if not uniq:
            return FalseLit()
        if len(uniq) == 1:
            return uniq[0]
        return Disjunction(tuple(uniq))
    if isinstance(f, Negation):
        return Negation(flatten(f.operand))
    return f


def _intersect_spectra(a: VAFSpectrum, b: VAFSpectrum) -> VAFSpectrum:
    """Conjunction merge (formula.rs merge_conjunctions semantics)."""
    if a.is_set and b.is_set:
        return VAFSpectrum.from_set([x for x in a.set_values if b.contains(x)])
    if a.is_set:
        return VAFSpectrum.from_set([x for x in a.set_values if b.contains(x)])
    if b.is_set:
        return VAFSpectrum.from_set([x for x in b.set_values if a.contains(x)])
    r = a.range_value.intersect(b.range_value)
    if r.is_empty:
        return VAFSpectrum.empty()
    if r.is_singleton:
        return VAFSpectrum.singleton(r.start)
    return VAFSpectrum.range(r)


def _try_union_spectra(a: VAFSpectrum, b: VAFSpectrum):
    """Disjunction merge: union if combinable into one spectrum, else None
    (formula.rs try_merge_disjunction)."""
    if a.is_set and b.is_set:
        return VAFSpectrum.from_set(list(a.set_values) + list(b.set_values))
    if a.is_set or b.is_set:
        sset, rng = (a, b) if a.is_set else (b, a)
        r = rng.range_value
        leftover = [v for v in sset.set_values if not r.contains(v)]
        new_r = r
        rest = []
        for v in leftover:
            if abs(v - r.start) < 1e-12 and r.left_exclusive:
                new_r = VAFRange(r.start, new_r.end, False, new_r.right_exclusive)
            elif abs(v - r.end) < 1e-12 and r.right_exclusive:
                new_r = VAFRange(new_r.start, r.end, new_r.left_exclusive, False)
            else:
                rest.append(v)
        if rest:
            return None
        return VAFSpectrum.range(new_r)
    ra, rb = a.range_value, b.range_value
    ov = ra.overlap(rb)
    if ov == "none":
        # adjacent ranges sharing a boundary where one side is inclusive?
        if ra.end == rb.start and not (ra.right_exclusive and rb.left_exclusive):
            return VAFSpectrum.range(
                VAFRange(ra.start, rb.end, ra.left_exclusive, rb.right_exclusive)
            )
        if rb.end == ra.start and not (rb.right_exclusive and ra.left_exclusive):
            return VAFSpectrum.range(
                VAFRange(rb.start, ra.end, rb.left_exclusive, ra.right_exclusive)
            )
        return None
    start, lex = min(
        (ra.start, ra.left_exclusive),
        (rb.start, rb.left_exclusive),
        key=lambda t: (t[0], t[1]),
    )
    end, rex = max(
        (ra.end, not ra.right_exclusive),
        (rb.end, not rb.right_exclusive),
        key=lambda t: (t[0], t[1]),
    )
    return VAFSpectrum.range(VAFRange(start, end, lex, not rex))


def merge_atoms(f):
    """formula.rs:575-689."""
    if isinstance(f, Conjunction):
        atoms: dict[str, VAFSpectrum] = {}
        others = []
        for o in f.operands:
            o = merge_atoms(o)
            if isinstance(o, Atom):
                if o.sample in atoms:
                    atoms[o.sample] = _intersect_spectra(atoms[o.sample], o.vafs)
                else:
                    atoms[o.sample] = o.vafs
            else:
                others.append(o)
        for sample, vafs in atoms.items():
            if vafs.is_empty:
                return FalseLit()
        ops = [Atom(sample=s, vafs=v) for s, v in atoms.items()] + others
        return Conjunction(tuple(ops)) if len(ops) > 1 else ops[0]
    if isinstance(f, Disjunction):
        by_sample: dict[str, list] = {}
        others = []
        for o in f.operands:
            o = merge_atoms(o)
            if isinstance(o, Atom):
                by_sample.setdefault(o.sample, []).append(o.vafs)
            else:
                others.append(o)
        ops = []
        for sample, spectra in by_sample.items():
            spectra.sort(key=lambda sp: sp.min_vaf() if not sp.is_empty else 0.0)
            merged = [spectra[0]]
            for sp in spectra[1:]:
                u = _try_union_spectra(merged[-1], sp)
                if u is not None:
                    merged[-1] = u
                else:
                    merged.append(sp)
            ops.extend(Atom(sample=sample, vafs=sp) for sp in merged)
        ops.extend(others)
        return Disjunction(tuple(ops)) if len(ops) > 1 else ops[0]
    if isinstance(f, Negation):
        return Negation(merge_atoms(f.operand))
    return f


def normalize(f, expressions: dict, universe_fn):
    """Full pipeline (formula.rs:473-485)."""
    f = expand_expressions(f, expressions)
    f = apply_negations(f, universe_fn)
    f = flatten(f)
    f = merge_atoms(f)
    f = flatten(f)
    # strip false from disjunctions
    if isinstance(f, Disjunction):
        ops = tuple(
            o
            for o in f.operands
            if not isinstance(o, FalseLit)
            and not (
                isinstance(o, Conjunction)
                and any(isinstance(x, FalseLit) for x in o.operands)
            )
        )
        if not ops:
            f = FalseLit()
        elif len(ops) == 1:
            f = ops[0]
        else:
            f = Disjunction(ops)
    return f


def formula_str(f) -> str:
    """Debug/log rendering (used in golden tests vs reference log output)."""
    if isinstance(f, Atom):
        return f"{f.sample}:{f.vafs}"
    if isinstance(f, Conjunction):
        return "(" + " & ".join(formula_str(o) for o in f.operands) + ")"
    if isinstance(f, Disjunction):
        return "(" + " | ".join(formula_str(o) for o in f.operands) + ")"
    if isinstance(f, Negation):
        return "!" + formula_str(f.operand)
    if isinstance(f, Variant):
        s = f"{f.refbase}>{f.altbase}"
        return s if f.positive else "!" + s
    if isinstance(f, Lfc):
        return f"l2fc({f.sample_a},{f.sample_b}) {f.op} {f.value}"
    if isinstance(f, TrueLit):
        return "true"
    if isinstance(f, FalseLit):
        return "false"
    return str(f)
