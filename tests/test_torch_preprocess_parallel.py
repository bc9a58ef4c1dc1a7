"""The port's host-parallel preprocess (``preprocess variants --threads N``).

On ``test_torch_preprocess.py``'s ``TINY_WORLD`` (20 kb, 6x, 50 candidates)
and on a hand-made candidate VCF of 16 SNVs on the world's contig (records
6-9 one ``EVENT`` group, records 10-12 at one position), with
``--device cpu``:

* ``--threads 2`` and ``--threads 3`` write the records of ``--threads 1``:
  ``compare.compare_observation_files`` finds no problem and no value that
  differs (largest relative error 0.0);
* the port's ``shard_cuts`` equals the cuts of the JAX package's
  ``_preprocess_parallel``, read from the jobs it hands to its pool (a
  stand-in pool runs the JAX workers in this process);
* each gate condition keeps the run serial, as in the JAX package:
  ``--report-fragment-ids``, a ``.vcf`` output, fewer than 4 N records;
* ``--region`` with ``--threads 2`` cuts only the region's records and
  equals ``--region`` alone;
* a worker asked for the card on a machine without one raises, never runs
  on the CPU, and a worker past the parent's timeout is stopped.

Each spawned worker imports torch and the port (~3 s here); every wait on
the workers is bounded by ``WORKER_TIMEOUT_S``.
"""

import multiprocessing
import time

import pytest

import varlociraptor_tpu.calling.preprocess as jax_pp
from varlociraptor_tpu.estimation.alignment_properties import (
    AlignmentProperties as JaxProperties,
)
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.bench_utils import synth_preprocess_world
from varlociraptor_tpu_torch.calling import preprocess as pp
from varlociraptor_tpu_torch.calling.observations import ObservationReader
from varlociraptor_tpu_torch.compare import compare_observation_files
from varlociraptor_tpu_torch.estimation.alignment_properties import estimate
from varlociraptor_tpu_torch.io.bam import BamReader
from varlociraptor_tpu_torch.io.fasta import FastaBuffer
from varlociraptor_tpu_torch.io.vcf import open_variant_file
from test_torch_preprocess import TINY_WORLD

WORKER_TIMEOUT_S = 120
N_HANDMADE = 16
EVENT = range(6, 10)  # one EVENT group across the 2-worker target cut 8
SAME_POS = range(10, 13)  # one site across the 3-worker target cut 11


@pytest.fixture(autouse=True)
def bounded_workers(monkeypatch):
    monkeypatch.setattr(pp, "worker_timeout_s", WORKER_TIMEOUT_S)


@pytest.fixture
def reports(monkeypatch):
    """The worker reports of each parallel preprocess run in the test."""
    seen = []
    monkeypatch.setattr(pp, "worker_hook", seen.extend)
    return seen


def _handmade_candidates(fasta, path):
    seq = FastaBuffer(fasta).seq("chr1")
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=chr1,length=20000>",
             '##INFO=<ID=EVENT,Number=1,Type=String,Description="event">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    pos = 1000
    for i in range(N_HANDMADE):
        if i not in SAME_POS or i == SAME_POS[0]:
            pos += 500
        ref = chr(seq[pos - 1])
        alt = "ACGT".replace(ref, "")[i % 3]
        info = "EVENT=ev1" if i in EVENT else "."
        lines.append(f"chr1\t{pos}\t.\t{ref}\t{alt}\t.\t.\t{info}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    w = synth_preprocess_world(tmp / "world", **TINY_WORLD)
    props = estimate(BamReader(w["normal"]), reference=FastaBuffer(w["fasta"]))
    w["props"] = str(tmp / "props.json")
    (tmp / "props.json").write_text(props.to_json())
    w["handmade"] = _handmade_candidates(w["fasta"], tmp / "handmade.vcf")
    return w


def _run(world, out, *flags, candidates="candidates"):
    assert cli.run(["preprocess", "variants", world["fasta"], "--bam", world["tumor"],
                    "--candidates", world[candidates], "--output", str(out),
                    "--alignment-properties", world["props"], "--device", "cpu",
                    *flags]) == 0
    return out


def _shards(records, threads):
    cuts = pp.shard_cuts(records, threads)
    return [[lo, hi] for lo, hi in zip(cuts, cuts[1:])]


def _same(ref, got, n):
    problems, info = compare_observation_files(ref, got)
    assert not problems, problems
    assert info["records"] == n
    assert all(v == 0.0 for v in info["max_rel"].values()), info
    return info


@pytest.mark.parametrize("threads", [2, 3])
@pytest.mark.parametrize("candidates", ["candidates", "handmade"])
def test_threads_match_serial(world, tmp_path, reports, candidates, threads):
    serial = _run(world, tmp_path / "serial.obs", candidates=candidates)
    assert not reports
    par = _run(world, tmp_path / "par.obs", "--threads", str(threads),
               candidates=candidates)
    records = list(open_variant_file(world[candidates]))
    n = len(records)
    _same(serial, par, n)
    assert len(reports) == threads
    assert [r["shard"] for r in reports] == _shards(records, threads)
    assert sum(r["records"] for r in reports) == n
    assert {r["device"] for r in reports} == {"cpu"}
    assert len({r["pid"] for r in reports}) == threads
    assert all(0 < r["ready_s"] <= r["end_s"] < WORKER_TIMEOUT_S for r in reports)
    reader = ObservationReader(str(par))
    assert reader.header["options"]["n_workers"] == threads
    reader.close()


class _InProcessPool:
    """Stands in for the JAX package's spawn pool: records each job's
    (lo, hi) and runs the job in this process."""

    def __init__(self, jobs):
        self.jobs = jobs

    def Pool(self, processes):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        self.jobs.extend((job[0], job[1]) for job in jobs)
        return [fn(job) for job in jobs]


@pytest.mark.parametrize("threads", [2, 3, 4])
@pytest.mark.parametrize("candidates", ["candidates", "handmade"])
def test_shard_cuts_match_jax(world, tmp_path, monkeypatch, candidates, threads):
    # the JAX workers run here: the XLA forward, nothing of the native one,
    # and the variables they set restored afterwards
    for name, value in (("VLT_NATIVE_PAIRHMM", "0"), ("VLT_NATIVE_THREADS", "1"),
                        ("JAX_PLATFORMS", "cpu"), ("VLT_HOP_STATES", "0")):
        monkeypatch.setenv(name, value)
    jobs = []
    monkeypatch.setattr(multiprocessing, "get_context", lambda method: _InProcessPool(jobs))
    props = JaxProperties.from_json(open(world["props"]).read())
    n = jax_pp.preprocess(world[candidates], world["tumor"], world["fasta"],
                          str(tmp_path / "jax.obs"), alignment_properties=props,
                          options=jax_pp.PreprocessOptions(n_workers=threads,
                                                           log_mode="silent"))
    records = list(open_variant_file(world[candidates]))
    cuts = pp.shard_cuts(records, threads)
    assert [lo for lo, _ in jobs] + [jobs[-1][1]] == cuts
    assert n == len(records) and len(cuts) == threads + 1
    if candidates == "handmade":
        # the EVENT group and the same-position records moved the targets
        assert cuts == {2: [0, 10, 16], 3: [0, 5, 13, 16], 4: [0, 4, 10, 13, 16]}[threads]


@pytest.mark.parametrize("gate,flags,threads,out_name", [
    ("fragment_ids", ["--report-fragment-ids"], 2, "x.obs"),
    ("vcf_output", [], 2, "x.vcf"),
    ("few_records", [], 13, "x.obs"),  # 50 < 4 x 13
])
def test_gates_keep_it_serial(world, tmp_path, reports, gate, flags, threads, out_name):
    got = _run(world, tmp_path / out_name, *flags, "--threads", str(threads))
    assert not reports  # no worker ran
    serial = _run(world, tmp_path / f"serial.{out_name}", *flags)
    if out_name.endswith(".obs"):
        _same(serial, got, world["n_candidates"])
    else:
        assert open(got).read() == open(serial).read()


def test_region_with_threads_matches_region(world, tmp_path, reports):
    region = ["--region", "chr1:2001-12000"]
    serial = _run(world, tmp_path / "serial.obs", *region)
    in_region = [r for r in open_variant_file(world["candidates"])
                 if 2000 <= r.pos < 12000]
    assert 8 <= len(in_region) < world["n_candidates"]
    par = _run(world, tmp_path / "par.obs", *region, "--threads", "2")
    _same(serial, par, len(in_region))
    assert [r["shard"] for r in reports] == _shards(in_region, 2)


def _job(world, path, device):
    """A job of ``_preprocess_parallel``: the first 10 candidates into ``path``."""
    opts = vars(pp.PreprocessOptions())
    return (0, 10, world["candidates"], world["tumor"], world["fasta"], str(path),
            "tumor", open(world["props"]).read(), opts, device, time.time())


def test_worker_never_falls_back_to_the_cpu(world, tmp_path):
    """A worker asked for the card, on a machine without one, raises (as the
    serial path does) and writes nothing."""
    with pytest.raises(RuntimeError, match="is_available"):
        pp._run_workers([_job(world, tmp_path / "shard.obs", "cuda")], WORKER_TIMEOUT_S)
    assert not (tmp_path / "shard.obs").exists()
    assert not multiprocessing.active_children()


def test_workers_past_the_timeout_are_stopped(world, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        pp._run_workers([_job(world, tmp_path / f"shard{k}.obs", "cpu") for k in range(2)],
                        0.5)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()
