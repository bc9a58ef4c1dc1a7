"""Testcase capture and replay in the port against the JAX package.

The all-kinds world (``bench_utils.KINDS_WORLD``) is
preprocessed by the port on the CPU.  From its observation files, ``call
variants generic --testcase-locus CHROM:POS --testcase-prefix DIR`` of both
CLIs captures one testcase per candidate kind (the first planted locus of
the kind): the non-anonymous captures must hold the same files (the YAML,
candidates, reference excerpt and scenario byte for byte, the BAM slices
record for record), the anonymous ones (a random base permutation and read
names) the same structure.  Then the port's capture replays through the
port's ``Testcase.run(device="cpu")`` and the JAX capture through the JAX
``Testcase.run`` on its kernel path (as tests/test_torch_preprocess.py runs
it); their calls must agree under ``compare_vcf_text``, and ``check()`` must
give the same outcome.
"""

import gzip

import pytest
import yaml

from varlociraptor_tpu import cli as jax_cli
from varlociraptor_tpu import testcase as jax_testcase
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch import testcase as port_testcase
from varlociraptor_tpu_torch.bench_utils import KINDS_WORLD, OTHER_KINDS, synth_preprocess_world
from varlociraptor_tpu_torch.compare import compare_vcf_text
from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
from varlociraptor_tpu_torch.io.bam import BamReader
from varlociraptor_tpu_torch.ops import pairhmm_column as phc

from test_torch_preprocess_kinds import _kernel_path, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("testcase")
    w = synth_preprocess_world(tmp / "world", **KINDS_WORLD)
    w["obs"] = {}
    for sample in ("tumor", "normal"):
        w["obs"][sample] = str(tmp / f"{sample}.obs")
        assert cli.run(["preprocess", "variants", w["fasta"], "--bam", w[sample],
                        "--candidates", w["candidates"], "--output", w["obs"][sample],
                        "--sample-name", sample, "--device", "cpu"]) == 0
    w["scenario"] = tmp / "scenario.yaml"
    w["scenario"].write_text(yaml.safe_dump(tumor_normal_scenario(0.75).doc))
    w["tmp"] = tmp
    return w


def _locus(world, kind):
    """1-based CHROM:POS of the kind's first planted record (its first
    record when none is planted)."""
    t = world["truth"]["kinds"][kind]
    planted = t.get("germline", []) + t.get("somatic", []) + t.get("methylated", [])
    return f"chr1:{min(planted or t['decoy']) + 1}"


def _capture(world, run, prefix, kind, anonymous):
    argv = ["call", "variants", "generic", "--scenario", str(world["scenario"]), "--obs",
            f"tumor={world['obs']['tumor']}", f"normal={world['obs']['normal']}",
            "--output", str(prefix) + ".calls.vcf", "--testcase-locus", _locus(world, kind),
            "--testcase-prefix", str(prefix)]
    if run is cli.run:
        argv += ["--device", "cpu"]
    assert run(argv + (["--testcase-anonymous"] if anonymous else [])) == 0
    return prefix


def _bam_records(path):
    return [(r.qname, r.flag, r.pos, r.mapq, r.cigar, r.mpos, r.tlen, bytes(r.seq),
             bytes(r.qual), sorted(r.tags)) for r in BamReader(path)]


@pytest.fixture(scope="module")
def captures(world):
    out = {}
    for kind in OTHER_KINDS:
        for anonymous in (False, True):
            tag = "anon" if anonymous else "plain"
            out[kind, anonymous] = tuple(
                _capture(world, run, world["tmp"] / f"{name}_{kind}_{tag}", kind, anonymous)
                for name, run in (("jax", jax_cli.run), ("torch", cli.run)))
    return out


@pytest.mark.parametrize("kind", OTHER_KINDS)
def test_capture_matches_jax(captures, kind):
    jax_dir, port_dir = captures[kind, False]
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir())
    assert {"testcase.yaml", "candidates.vcf", "ref.fa", "scenario.yaml",
            "tumor.bam", "normal.bam"} <= set(names)
    for name in names:
        a, b = (jax_dir / name).read_bytes(), (port_dir / name).read_bytes()
        if name.endswith(".bam"):
            assert gzip.decompress(a) == gzip.decompress(b), name
            assert _bam_records(jax_dir / name) == _bam_records(port_dir / name)
        else:
            assert a == b, name
    records = [ln for ln in (port_dir / "candidates.vcf").read_text().splitlines()
               if not ln.startswith("#")]
    assert records and len(_bam_records(port_dir / "tumor.bam")) > 0


@pytest.mark.parametrize("kind", OTHER_KINDS)
def test_anonymous_capture_has_the_structure_of_jax(captures, kind):
    jax_dir, port_dir = captures[kind, True]
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())
    ja, pa = (yaml.safe_load((d / "testcase.yaml").read_text()) for d in (jax_dir, port_dir))
    assert ja == pa  # paths, properties, options; no sequence in the YAML
    for name in ("tumor.bam", "normal.bam"):
        j, p = _bam_records(jax_dir / name), _bam_records(port_dir / name)
        assert [r[1:7] for r in j] == [r[1:7] for r in p]  # flags, positions, CIGARs
        assert [len(r[7]) for r in j] == [len(r[7]) for r in p]
        assert len({r[0] for r in p}) == len({r[0] for r in j})  # read names: uuids
    cols = lambda d: [ln.split("\t")[:3] for ln in (d / "candidates.vcf").read_text()  # noqa: E731
                      .splitlines() if not ln.startswith("#")]
    assert cols(jax_dir) == cols(port_dir)
    ref_len = lambda d: len("".join((d / "ref.fa").read_text().split("\n")[1:]))  # noqa: E731
    assert ref_len(jax_dir) == ref_len(port_dir)


@pytest.mark.parametrize("kind", OTHER_KINDS)
def test_replay_matches_jax(captures, tmp_path, monkeypatch, kind):
    jax_dir, port_dir = captures[kind, False]
    jax_calls = _kernel_path(monkeypatch)
    port_calls = []
    fn = phc.exact_forward
    monkeypatch.setattr(phc, "exact_forward", lambda *a, **kw: port_calls.append(1) or fn(*a, **kw))
    jax_records, jax_samples = jax_testcase.Testcase(jax_dir).run(tmp_path / "jax")
    records, samples = port_testcase.Testcase(port_dir).run(tmp_path / "torch", device="cpu")
    assert samples == jax_samples and len(records) == len(jax_records) > 0
    problems, _ = compare_vcf_text((tmp_path / "jax" / "calls.vcf").read_text(),
                                   (tmp_path / "torch" / "calls.vcf").read_text())
    assert not problems, (kind, problems)
    # both packages ran the pair-HMM equally often (K2: the estimate keeps
    # zero extension on these slices); the SV and replacement slices need it,
    # the MNV, <*> and methylation ones are scored without realignment here
    assert len(port_calls) == len(jax_calls)
    assert bool(port_calls) == (kind in ("inversion", "duplication", "replacement", "breakend"))
    outcome = []
    for tc, kw in ((jax_testcase.Testcase(jax_dir), {}),
                   (port_testcase.Testcase(port_dir), {"device": "cpu"})):
        try:
            outcome.append(tc.check(tmp_path / f"check{len(outcome)}", **kw))
        except Exception as e:  # noqa: BLE001 - the outcome is what is compared
            outcome.append(type(e).__name__)
    assert outcome[0] == outcome[1], outcome
