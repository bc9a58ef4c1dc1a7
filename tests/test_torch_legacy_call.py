"""The port's legacy per-WorkItem caller (calling/call.py: ``make_work_item``,
``call_batch`` through ``PosteriorEngine.run``, ``_result_to_record``) and its
record-by-record reading of reference-format observation files, against the
JAX package.

* ``VLT_LEGACY_CALL=1`` on ``synth_observation_files`` (300 loci): the port's
  ``call_generic`` (``device="cpu"``) against JAX's ``call_generic`` under
  the same variable, tumor-normal, ``--full-prior`` and two sets of
  ``omit_*`` options; and on tests/test_columnar_call.py's random pileups
  (every bias dimension, homopolymer reads, artifact calls: the
  ``slot_map`` / ``map_combo`` letters).  JAX's own columnar and legacy paths
  differ by up to 0.3 PHRED, so the legacy path is held to JAX's legacy
  path only.
* ``call_processor``: the result dicts both packages pass agree.
* ``candidate_filter``: the same loci are skipped, and the WorkItems passed
  carry the same ``index``, flags, SNV key and hints.
* reference observation VCFs (the v15 format): written by both packages'
  ``preprocess`` for ``test_torch_preprocess.TINY_WORLD`` and by JAX's
  ``ReferenceObservationWriter`` from the synthetic files, each called by
  both packages on the columnar and on the legacy path.  The v15 encoding is
  lossy, so a file is compared only with a call of the same file.
* inconsistent files (different lengths, different loci) raise the same
  errors on both paths.

Tolerances (varlociraptor_tpu_torch/compare.py): VCF numbers within
1.1e-4 * max(1, |x|) (``compare_vcf_text``; PHRED values are printed from
float32 sums taken in another order), AFD points within one deci-PHRED step,
every other byte identical (the FORMAT strings OBS, SAOBS, SROBS and the
bias letters SB, ROB, RPB, SCB, HE, ALB as text).  Where the reference's two
most probable events print the same PHRED, the MAP event is a tie that
float32 (JAX) and float64 (the port) read sums may break either way (ROADMAP
C); on such a record (one of the 61 random pileups: a deletion with a
single uninformative tumor read) AF and AFD, which follow the MAP event, are
left out, and everything else is compared.  Result dicts: event
probabilities 1e-4 * max(1, |x|), MAP AF within ``compare.AF_TOL``, AFD
points equal and their log densities within one deci-PHRED step
(ln(10) / 100 nats), hints and depths equal.
"""

import contextlib
import math
import os

import numpy as np
import pytest

from varlociraptor_tpu import cli as jcli
from varlociraptor_tpu.calling import call as jcall
from varlociraptor_tpu.calling.observations import ObservationReader as JReader
from varlociraptor_tpu.calling.observations import ObservationWriter as JWriter
from varlociraptor_tpu.calling.ref_obs import ReferenceObservationWriter as JRefWriter
from varlociraptor_tpu.calling.ref_obs import open_observations as jopen
from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario as jtn
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.bench_utils import (
    synth_observation_files,
    synth_preprocess_world,
)
from varlociraptor_tpu_torch.calling import call as tcall
from varlociraptor_tpu_torch.compare import AF_TOL, compare_vcf_text, vcf_record_keys
from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario as ttn
from test_columnar_call import _dataset
from test_torch_preprocess import TINY_WORLD

N_LOCI = 300
DPHRED_NATS = math.log(10.0) / 100.0

OPTION_SETS = {
    "tumor_normal": {},
    "full_prior": {"full_prior": True},
    "omit_sb_rob": {"omit_strand_bias": True, "omit_read_orientation_bias": True},
    "omit_rpb_scb_he_alb": {
        "omit_read_position_bias": True, "omit_softclip_bias": True,
        "omit_homopolymer_artifact_detection": True, "omit_alt_locus_bias": True,
    },
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("legacy")
    tumor, normal, _ = synth_observation_files(d / "obs", n_loci=N_LOCI, seed=0)
    return d, {"tumor": tumor, "normal": normal}


@pytest.fixture(scope="module")
def random_pileups(tmp_path_factory):
    """tests/test_columnar_call.py's random pileups (seed 13, 60 loci) as
    tumor / normal observation files."""
    d = tmp_path_factory.mktemp("random")
    data = _dataset(seed=13, n=60)
    obs = {}
    for si, name in enumerate(jtn(0.75).sample_names):
        path = d / f"{name}.obs.jsonl"
        with JWriter(path, name) as w:
            for v, ps in data:
                w.write_record(v, ps[si])
        obs[name] = str(path)
    return d, obs


@contextlib.contextmanager
def _legacy_call(on):
    """``VLT_LEGACY_CALL=1`` inside (both packages read it per call), or
    unset."""
    saved = os.environ.pop("VLT_LEGACY_CALL", None)
    if on:
        os.environ["VLT_LEGACY_CALL"] = "1"
    try:
        yield
    finally:
        os.environ.pop("VLT_LEGACY_CALL", None)
        if saved is not None:
            os.environ["VLT_LEGACY_CALL"] = saved


def _call_both(obs, out_dir, tag, legacy, options=None, jax_kw=None, torch_kw=None):
    """One tumor-normal call (purity 0.75) of each package on the same
    files; returns both VCF texts and record counts."""
    options = options or {}
    js, ts = jtn(0.75), ttn(0.75)
    ref, got = out_dir / f"{tag}.jax.vcf", out_dir / f"{tag}.torch.vcf"
    with _legacy_call(legacy):
        n_ref = jcall.call_generic(js, obs, str(ref), jcall.CallOptions(**options),
                                   **(jax_kw or {}))
        n_got = tcall.call_generic(ts, obs, str(got), tcall.CallOptions(**options),
                                   device="cpu", **(torch_kw or {}))
    return ref.read_text(), got.read_text(), n_ref, n_got


def _map_event_tie(line):
    """Whether the reference record's two most probable events print the
    same PHRED (ROADMAP C, "ties between events": the MAP event then
    follows float32 rounding in JAX and float64 in the port)."""
    info = dict(kv.split("=", 1) for kv in line.split("\t")[7].split(";") if "=" in kv)
    phred = sorted(float(v) for k, v in info.items()
                   if k.startswith("PROB_") and k != "PROB_ARTIFACT"
                   and v not in (".", "inf"))
    return len(phred) >= 2 and phred[0] == phred[1]


def _without_map_fields(line):
    """A record without its per-sample AF and AFD, the two fields that
    depend on which event is the MAP one."""
    cols = line.split("\t")
    keys = cols[8].split(":")
    drop = {keys.index("AF"), keys.index("AFD")}
    return "\t".join(cols[:9] + [
        ":".join(v for i, v in enumerate(c.split(":")) if i not in drop) for c in cols[9:]
    ])


def _assert_vcfs_agree(ref, got, n_ref, n_got):
    """compare_vcf_text, except that on a record whose MAP event is a tie in
    the reference only the fields that do not depend on the MAP event are
    compared (the PROB_* values are, within the tolerance)."""
    assert n_got == n_ref
    assert len(vcf_record_keys(got)) == n_ref
    ra, ga = ref.splitlines(keepends=True), got.splitlines(keepends=True)
    ties = [i for i, line in enumerate(ra) if not line.startswith("#") and _map_event_tie(line)]
    for i in ties:
        if len(ga) > i:
            ra[i], ga[i] = _without_map_fields(ra[i]), _without_map_fields(ga[i])
    problems, swapped = compare_vcf_text("".join(ra), "".join(ga))
    assert not problems, problems[:5]
    assert len(ties) <= max(1, n_ref // 50), ties
    if swapped or ties:
        print("AFD top-K swaps between equal-density points, lines:", swapped,
              "MAP-event ties, lines:", [i + 1 for i in ties])


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_legacy_call_matches_jax(synth, name):
    d, obs = synth
    ref, got, n_ref, n_got = _call_both(obs, d, name, legacy=True, options=OPTION_SETS[name])
    assert n_ref == N_LOCI
    _assert_vcfs_agree(ref, got, n_ref, n_got)


def test_legacy_call_on_random_pileups_matches_jax(random_pileups):
    """Every bias dimension and homopolymer reads: artifact calls whose
    bias letters come from ``slot_map`` after ``compact_combos``."""
    d, obs = random_pileups
    ref, got, n_ref, n_got = _call_both(obs, d, "random", legacy=True)
    _assert_vcfs_agree(ref, got, n_ref, n_got)
    letters = [line.split("\t")[9].split(":")[6:12] for line in got.splitlines()
               if line and not line.startswith("#")]
    assert any(set(x) != {"."} for x in letters), "no artifact call to test slot_map on"


def test_legacy_call_batch_pads_the_locus_axis(synth, monkeypatch):
    """Every engine call of the legacy path sees the padded batch of
    ``DEFAULT_BATCH`` loci and a power-of-two depth, also for the last,
    partial batch."""
    d, obs = synth
    from varlociraptor_tpu_torch.ops.posterior import PosteriorEngine

    shapes = []
    run = PosteriorEngine.run

    def spy(self, feats, mask, *a, **kw):
        shapes.append(np.asarray(feats).shape)
        return run(self, feats, mask, *a, **kw)

    monkeypatch.setattr(PosteriorEngine, "run", spy)
    with _legacy_call(True):
        n = tcall.call_generic(ttn(0.75), obs, str(d / "pad.vcf"), device="cpu")
    assert n == N_LOCI
    assert len(shapes) == -(-N_LOCI // tcall.DEFAULT_BATCH)
    for L, S, D, _ in shapes:
        assert (L, S) == (tcall.DEFAULT_BATCH, 2) and D & (D - 1) == 0


def _collector(out):
    def processor(res):
        out.append(res)
    return processor


def test_call_processor_results_match_jax(synth):
    d, obs = synth
    ref_res, got_res = [], []
    ref, got, n_ref, n_got = _call_both(
        obs, d, "processor", legacy=False,
        jax_kw={"call_processor": _collector(ref_res)},
        torch_kw={"call_processor": _collector(got_res)},
    )
    _assert_vcfs_agree(ref, got, n_ref, n_got)
    assert len(got_res) == len(ref_res) == N_LOCI
    for a, b in zip(ref_res, got_res):
        va, vb = a["variant"], b["variant"]
        assert (vb.chrom, vb.pos, vb.ref_allele, vb.alt_allele) == (
            va.chrom, va.pos, va.ref_allele, va.alt_allele)
        assert b["hints"] == a["hints"]
        assert b["event_probs"].keys() == a["event_probs"].keys()
        for k, x in a["event_probs"].items():
            y = b["event_probs"][k]
            assert np.isfinite(x) == np.isfinite(y), k
            if np.isfinite(x):
                assert abs(x - y) <= 1e-4 * max(1.0, abs(x)), (k, x, y)
        assert len(b["sample_infos"]) == len(a["sample_infos"])
        for sa, sb in zip(a["sample_infos"], b["sample_infos"]):
            assert abs(sa["af"] - sb["af"]) <= AF_TOL
            assert sb["dp"] == sa["dp"]
            assert sb["artifacts"] == sa["artifacts"]
            assert (sa["afd"] is None) == (sb["afd"] is None)
            if sa["afd"] is not None:
                assert sb["afd"].keys() == sa["afd"].keys()
                for g, p in sa["afd"].items():
                    assert abs(sb["afd"][g] - p) <= DPHRED_NATS + 1e-9, (g, p, sb["afd"][g])


def test_candidate_filter_skips_the_same_loci(synth):
    """A filter of the contamination kind (deep pileups, alt support in the
    tumor) and every third locus dropped: both packages hand the filter the
    same WorkItems and call the same loci."""
    d, obs = synth
    seen = {"jax": [], "torch": []}

    def make(side):
        def keep(item):
            seen[side].append((item.index, item.variant.pos, item.flags, item.snv,
                               list(item.hints),
                               [len(p.read_observations) for p in item.pileups]))
            tumor = item.pileups[0].read_observations
            return (item.variant.pos // 10) % 3 != 0 and (
                len(tumor) >= 30 or any(o.is_strong_alt_support() for o in tumor))
        return keep

    ref, got, n_ref, n_got = _call_both(
        obs, d, "filter", legacy=False,
        jax_kw={"candidate_filter": make("jax")},
        torch_kw={"candidate_filter": make("torch")},
    )
    assert seen["torch"] == seen["jax"]
    assert len(seen["jax"]) == N_LOCI
    assert 0 < n_ref < N_LOCI
    _assert_vcfs_agree(ref, got, n_ref, n_got)


@pytest.fixture(scope="module")
def reference_format(synth, tmp_path_factory):
    """Reference-format observation VCFs: both packages' preprocess on the
    tiny BAM world, and the synthetic files re-encoded by JAX's writer."""
    d = tmp_path_factory.mktemp("v15")
    w = synth_preprocess_world(d / "world", **TINY_WORLD)
    files = {"preprocess_torch": {}, "preprocess_jax": {}, "synthetic": {}}
    for s in ("tumor", "normal"):
        for side, run, extra in (("torch", cli.run, ["--device", "cpu"]),
                                 ("jax", jcli.run, [])):
            out = d / f"{s}.{side}.obs.vcf"
            assert run(["preprocess", "variants", w["fasta"], "--bam", w[s],
                        "--candidates", w["candidates"], "--output", str(out),
                        "--sample-name", s] + extra) == 0
            files[f"preprocess_{side}"][s] = str(out)
        src = JReader(synth[1][s])
        out = d / f"{s}.synth.obs.vcf"
        with JRefWriter(str(out), s) as wr:
            for variant, pileup in src:
                wr.write_record(variant, pileup)
        src.close()
        files["synthetic"][s] = str(out)
    return d, files, w["n_candidates"]


@pytest.mark.parametrize("legacy", [False, True], ids=["columnar", "legacy"])
@pytest.mark.parametrize("source", ["preprocess_torch", "preprocess_jax", "synthetic"])
def test_reference_observation_files_match_jax(reference_format, source, legacy):
    d, files, n_candidates = reference_format
    obs = files[source]
    assert open(obs["tumor"]).readline().startswith("##fileformat=VCF")
    ref, got, n_ref, n_got = _call_both(obs, d, f"{source}.{legacy}", legacy=legacy)
    assert n_ref == (N_LOCI if source == "synthetic" else n_candidates)
    _assert_vcfs_agree(ref, got, n_ref, n_got)


def test_cli_calls_reference_observation_files(reference_format):
    d, files, n_candidates = reference_format
    obs = files["preprocess_torch"]
    out = d / "cli.vcf"
    assert cli.run(["call", "variants", "tumor-normal", "--tumor", obs["tumor"],
                    "--normal", obs["normal"], "--purity", "0.75", "--device", "cpu",
                    "--output", str(out)]) == 0
    ref = d / "cli.jax.vcf"
    assert jcli.run(["call", "variants", "tumor-normal", "--tumor", obs["tumor"],
                     "--normal", obs["normal"], "--purity", "0.75",
                     "--output", str(ref)]) == 0
    _assert_vcfs_agree(ref.read_text(), out.read_text(), n_candidates,
                       len(vcf_record_keys(out.read_text())))


def _shortened(src, dst, keep, shift=None):
    """The records of ``src`` whose index ``keep`` accepts, in the format of
    ``src`` (a ``.vcf`` is written in the v15 format); ``shift`` moves one
    record's position (different loci)."""
    reader = jopen(src)
    writer = JRefWriter if str(src).endswith(".vcf") else JWriter
    with writer(str(dst), reader.header.get("sample") or "normal") as w:
        for i, (variant, pileup) in enumerate(reader):
            if not keep(i):
                continue
            if shift is not None and i == shift:
                variant.pos += 1
            w.write_record(variant, pileup)
    reader.close()
    return str(dst)


@pytest.mark.parametrize("legacy", [False, True], ids=["columnar", "legacy"])
@pytest.mark.parametrize("fault", ["lengths", "loci"])
@pytest.mark.parametrize("fmt", ["obs", "vcf"])
def test_inconsistent_files_raise_the_same_errors(synth, reference_format, fault, fmt,
                                                  legacy, tmp_path):
    d, obs = synth
    if fmt == "vcf":
        obs = reference_format[1]["synthetic"]
    normal = tmp_path / ("normal.obs.vcf" if fmt == "vcf" else "normal.obs.jsonl")
    if fault == "lengths":
        _shortened(obs["normal"], normal, lambda i: i < 10)
    else:
        _shortened(obs["normal"], normal, lambda i: True, shift=5)
    bad = {"tumor": obs["tumor"], "normal": str(normal)}
    errors = []
    for side, mod, scen in (("jax", jcall, jtn), ("torch", tcall, ttn)):
        kw = {"device": "cpu"} if side == "torch" else {}
        with _legacy_call(legacy), pytest.raises(ValueError) as exc:
            mod.call_generic(scen(0.75), bad, str(tmp_path / f"{side}.vcf"), **kw)
        errors.append(str(exc.value))
    assert errors[1] == errors[0]
    assert errors[0].startswith("inconsistent observation files")
