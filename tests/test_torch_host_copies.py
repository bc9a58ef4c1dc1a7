"""The port's verbatim copies of JAX-package host modules stay verbatim.

The port imports nothing of ``varlociraptor_tpu``, not even its jax-free host
modules, so it carries its own copy of every host module that the call stage
and preprocess reach (and ``utils.logprob``, whose original imports
``jax.numpy`` at module top).  Each copy must equal its original except for
import lines (imports within the port only), the top-level functions it
leaves out on purpose (the ``jnp_*`` helpers), the
top-level functions named in ``PORTED`` (rewritten for torch and a device,
held to the JAX package by their own tests), the lines named in
``REWRITTEN`` (where the port's native host library lives, what a module's
docstring says of its device code, the default mesh of the sharded FDR and the
FDR filter's tracing span, the reading of BGZF BCF observation
files, the ``device`` of the testcase runner, the port's own package name in
a docstring and a logger name), and paths into the Rust reference's
sources, which the copies cite from the reference repository's root
(``src/...``).  The native host library's C++
source is a byte-for-byte copy of ``native/vlt_native.cpp``."""

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
    "filtration/fdr.py": set(),
    "evidence/realignment.py": set(),
    "evidence/variants.py": set(),
    "evidence/extraction.py": set(),
    "evidence/indels.py": set(),
    "evidence/breakends.py": set(),
    "evidence/haplotype_block.py": set(),
    "evidence/methylation.py": set(),
    "errors.py": set(),
    "io/__init__.py": set(),
    "io/bam.py": set(),
    "io/bam_index.py": set(),
    "io/cram.py": set(),
    "io/bcf.py": set(),
    "io/vcf.py": set(),
    "io/fasta.py": set(),
    "io/native.py": set(),
    "grammar/__init__.py": set(),
    "grammar/formula.py": set(),
    "grammar/scenario.py": set(),
    "grammar/compiler.py": set(),
    "ops/grid.py": set(),
    "ops/prior.py": set(),
    "ops/event_program.py": set(),
    "calling/variants.py": set(),
    "estimation/__init__.py": set(),
    "estimation/alignment_properties.py": set(),
    "evidence/edit_distance.py": set(),
    "utils/rust_rand.py": set(),
    "estimation/contamination.py": set(),
    "calling/cnvs.py": set(),
    "candidates/__init__.py": set(),
    "candidates/methylation.py": set(),
    "filtration/posterior_odds.py": set(),
    "conversion/__init__.py": set(),
    "conversion/decode_phred.py": set(),
    "conversion/genotype.py": set(),
    "estimation/mutational_burden.py": set(),
    "estimation/effective_mutation_rate.py": set(),
    "estimation/sample_variants.py": set(),
    "estimation/prior_plot.py": set(),
    "testcase_builder.py": set(),
    "testcase.py": set(),
}

# copy -> top-level functions that the copy rewrites: the torch Viterbi and
# the ``device`` parameter of the entry points (tests/test_torch_cnvs.py,
# tests/test_torch_contamination.py hold them to the JAX package)
PORTED = {
    "estimation/contamination.py": {"estimate_contamination"},
    "calling/cnvs.py": {"viterbi", "call_cnvs"},
}

# copy -> {line of the copy: the original's line (None: the copy adds it)}.
# The port builds its own native/vlt_native.cpp into build/torch_native/;
# the JAX package builds native/vlt_native.cpp next to its source.
REWRITTEN = {
    "io/native.py": {
        '_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"':
            '_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"',
        '_LIB = _NATIVE_DIR.parent.parent / "build" / "torch_native" / "libvlt_native.so"':
            '_LIB = _NATIVE_DIR / "libvlt_native.so"',
        '        _LIB.parent.mkdir(parents=True, exist_ok=True)': None,
    },
    # the JAX package's sniffing of a gzip-framed file reads a BGZF BCF as
    # text and fails on its first non-UTF-8 byte, so it cannot open the
    # reference's v15 .bcf observation files; the port reads them
    "calling/ref_obs.py": {
        '        except (OSError, UnicodeDecodeError):  # a BGZF BCF is binary':
            "        except OSError:",
    },
    # Testcase.run and Testcase.check take the device of preprocess and
    # call (tests/test_torch_testcase.py replays captures against JAX)
    "testcase.py": {
        '    def run(self, workdir=None, pairhmm_mode=None, obs_suffix="jsonl", device="cuda"):':
            '    def run(self, workdir=None, pairhmm_mode=None, obs_suffix="jsonl"):',
        "        ``device``: where the pair-HMM (preprocess) and the posterior engine": None,
        '        (call) run, "cuda" or "cpu".': None,
        "                device=device,": None,
        "        call_generic(scenario, obs_paths, out_vcf, call_options, device=device)":
            "        call_generic(scenario, obs_paths, out_vcf, call_options)",
        '    def check(self, workdir=None, pairhmm_mode=None, device="cuda"):':
            "    def check(self, workdir=None, pairhmm_mode=None):",
        "        records, sample_order = self.run(workdir, pairhmm_mode=pairhmm_mode, device=device)":
            "        records, sample_order = self.run(workdir, pairhmm_mode=pairhmm_mode)",
    },
    # the sharded FDR's default mesh: one shard per visible card (the
    # original's ``locus_mesh(jax.devices())``; its ``import jax`` is an
    # import line), and the FDR filter's tracing span
    "filtration/fdr.py": {
        "            mesh = locus_mesh()": "            mesh = locus_mesh(jax.devices())",
        '@tracing.traced("fdr.control")': None,
    },
    # the port's own package names where the original names its own
    "testcase_builder.py": {
        "The produced directory replays through ``varlociraptor_tpu_torch.testcase.Testcase``.":
            "The produced directory replays through ``varlociraptor_tpu.testcase.Testcase``.",
    },
    "estimation/mutational_burden.py": {
        'log = logging.getLogger("varlociraptor_tpu_torch.tmb")':
            'log = logging.getLogger("varlociraptor_tpu.tmb")',
    },
    "calling/cnvs.py": {
        "Device shape: the emission matrix [T loci, K states] is computed as one":
            "TPU-first shape: the emission matrix [T loci, K states] is computed as one",
        "vectorized batch and the Viterbi recursion runs as a torch loop over loci":
            "vectorized batch and the Viterbi recursion runs as a ``lax.scan`` over loci",
    },
}

_IMPORT = re.compile(r"^\s*(import\s|from\s+\S+\s+import\s)")
_REFERENCE_SRC = re.compile(r"``\S*/reference/src/")


def _body(path, omit, rewritten=None):
    """Source lines without import lines, blank lines and the ``omit``
    top-level functions; lines named in ``rewritten`` become the original's."""
    rewritten = rewritten or {}
    text = path.read_text()
    drop = set()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name in omit:
            first = min([node.lineno] + [d.lineno for d in node.decorator_list])
            drop.update(range(first, node.end_lineno + 1))
    return [
        _REFERENCE_SRC.sub("``src/", rewritten.get(line, line))
        for i, line in enumerate(text.splitlines(), 1)
        if i not in drop and line.strip() and not _IMPORT.match(line)
        and rewritten.get(line, line) is not None
    ]


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_is_verbatim(rel):
    ported = PORTED.get(rel, set())
    orig = _body(ORIG / rel, COPIES[rel] | ported)
    copy = _body(PORT / rel, ported, REWRITTEN.get(rel))
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
    # the rewritten ones are there
    assert ported <= names


def test_native_host_library_is_the_ports_own():
    """The port's C++ source equals the JAX package's byte for byte, its
    ``io/native.py`` differs only in the lines of ``REWRITTEN``, and it builds
    from the port's source into ``build/``, never into ``native/``."""
    from varlociraptor_tpu_torch.io import native

    assert (PORT / "native/vlt_native.cpp").read_bytes() == \
        (ROOT / "native/vlt_native.cpp").read_bytes()
    text = (PORT / "io/native.py").read_text().splitlines()
    for line in REWRITTEN["io/native.py"]:
        assert text.count(line) == 1, line
    assert native._SRC == PORT / "native" / "vlt_native.cpp"
    assert native._LIB.parent == ROOT / "build" / "torch_native"


def test_compact_obs_host_constants_match():
    from varlociraptor_tpu.ops import compact_obs as j
    from varlociraptor_tpu_torch.ops import compact_obs as t

    names = [n for n in dir(j) if re.fullmatch(r"(CF|CU|N|FLAG)_[A-Z_]+", n)]
    assert {"N_CF", "N_CU", "FLAG_IS_MAX_MAPQ", "CU_FLAGS", "CF_PSA"} <= set(names)
    for n in names:
        assert getattr(t, n) == getattr(j, n), n
    assert np.array_equal(t.COMBO_CODES, j.COMBO_CODES)
    assert t.COMBO_CODES.dtype == j.COMBO_CODES.dtype
