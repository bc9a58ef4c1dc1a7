"""The port's verbatim copies of JAX-package host modules stay verbatim.

The JAX package's host modules import ``utils.logprob``, which imports
``jax.numpy`` at module top, so the port carries numpy copies of the ones the
call stage and preprocess need.  Each copy must equal its original except
for import lines (relative imports of modules the port does not copy become
absolute imports of ``varlociraptor_tpu``), the top-level functions it leaves out on
purpose (the ``jnp_*`` helpers, the sharded FDR), and paths into the Rust
reference's sources, which the copies cite from the reference repository's
root (``src/...``)."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
ORIG = ROOT / "varlociraptor_tpu"
PORT = ROOT / "varlociraptor_tpu_torch"

# copy -> top-level functions of the original that the copy leaves out
COPIES = {
    "utils/logprob.py": {
        "jnp_ln_add_exp", "jnp_ln_sum_exp", "jnp_ln_one_minus_exp",
        "jnp_cap_numerical_overshoot", "jnp_phred_from_log", "jnp_log_from_phred",
    },
    "evidence/observation.py": set(),
    "ops/biases.py": set(),
    "calling/observations.py": set(),
    "calling/ref_obs.py": set(),
    "calling/columnar.py": set(),
    "filtration/fdr.py": {"control_fdr_sharded"},
    "evidence/realignment.py": set(),
    "evidence/variants.py": set(),
    "evidence/extraction.py": set(),
    "evidence/indels.py": set(),
    "evidence/breakends.py": set(),
    "evidence/haplotype_block.py": set(),
    "evidence/methylation.py": set(),
}

_IMPORT = re.compile(r"^\s*(import\s|from\s+\S+\s+import\s)")
_REFERENCE_SRC = re.compile(r"``\S*/reference/src/")


def _body(path, omit):
    """Source lines without import lines, blank lines and the ``omit``
    top-level functions."""
    text = path.read_text()
    drop = set()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name in omit:
            first = min([node.lineno] + [d.lineno for d in node.decorator_list])
            drop.update(range(first, node.end_lineno + 1))
    return [
        _REFERENCE_SRC.sub("``src/", line)
        for i, line in enumerate(text.splitlines(), 1)
        if i not in drop and line.strip() and not _IMPORT.match(line)
    ]


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_is_verbatim(rel):
    orig, copy = _body(ORIG / rel, COPIES[rel]), _body(PORT / rel, set())
    first_diff = next(
        (i for i, (a, b) in enumerate(zip(orig, copy)) if a != b),
        min(len(orig), len(copy)),
    )
    assert orig == copy, (
        f"{rel} drifted at body line {first_diff}: "
        f"{orig[first_diff:first_diff + 1]} vs {copy[first_diff:first_diff + 1]}"
    )
    # the omitted functions are really gone from the copy
    names = {n.name for n in ast.parse((PORT / rel).read_text()).body
             if isinstance(n, ast.FunctionDef)}
    assert not names & COPIES[rel]


def test_compact_obs_host_constants_match():
    from varlociraptor_tpu.ops import compact_obs as j
    from varlociraptor_tpu_torch.ops import compact_obs as t

    names = [n for n in dir(j) if re.fullmatch(r"(CF|CU|N|FLAG)_[A-Z_]+", n)]
    assert {"N_CF", "N_CU", "FLAG_IS_MAX_MAPQ", "CU_FLAGS", "CF_PSA"} <= set(names)
    for n in names:
        assert getattr(t, n) == getattr(j, n), n
    assert np.array_equal(t.COMBO_CODES, j.COMBO_CODES)
    assert t.COMBO_CODES.dtype == j.COMBO_CODES.dtype
