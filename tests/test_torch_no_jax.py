"""The port runs without JAX and without the JAX package, and never falls
back from CUDA to the CPU.

* a subprocess that blocks ``jax``, ``jaxlib`` and ``varlociraptor_tpu``
  (through ``scripts/torch_no_jax/sitecustomize.py`` on its ``PYTHONPATH``,
  so that the processes it spawns are blocked too) imports the port and runs
  its CLI ``call variants tumor-normal`` and ``filter-calls control-fdr`` on
  tiny synthetic observation files, and ``estimate alignment-properties`` and
  ``preprocess variants`` (default, ``--pairhmm-mode homopolymer`` with
  hop params, and ``--threads 2``: two spawned workers) on a tiny synthetic
  BAM world, with ``--device cpu``;
* ``--device cuda`` on a machine without a usable card raises, for ``call``
  and for ``preprocess``;
* no file of the port (nor chip_smoke.py and the port's scripts) imports
  jax or the JAX package ``varlociraptor_tpu``, not even its jax-free host
  modules: the port keeps its own copies of those.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.bench_utils import (
    synth_observation_files,
    synth_preprocess_world,
)
from varlociraptor_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "varlociraptor_tpu_torch"

_BLOCKED_RUN = r"""
import sys
import multiprocessing
blocked = "__import__('sys').modules['jax'] is __import__('sys').modules['varlociraptor_tpu'] is None"
assert eval(blocked)
with multiprocessing.get_context("spawn").Pool(1) as pool:  # as the workers start
    assert pool.apply(eval, (blocked,))
sys.path.insert(0, sys.argv[1])
work = sys.argv[2]
from varlociraptor_tpu_torch import cli
from varlociraptor_tpu_torch.bench_utils import (
    synth_observation_files, synth_preprocess_world,
)
tumor, normal, _ = synth_observation_files(work, n_loci=40, seed=1)
assert cli.run(["call", "variants", "tumor-normal", "--tumor", tumor,
                "--normal", normal, "--purity", "0.75", "--device", "cpu",
                "--output", work + "/calls.vcf"]) == 0
assert cli.run(["filter-calls", "control-fdr", work + "/calls.vcf", "--events",
                "somatic_tumor", "--fdr", "0.05", "--output",
                work + "/kept.vcf"]) == 0
w = synth_preprocess_world(work + "/world", seed=3, genome_len=8000, coverage=4.0,
                           n_germline=4, n_somatic=3, n_decoy=3, n_snv=2)
import contextlib, io, math
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert cli.run(["estimate", "alignment-properties", w["fasta"], "--bam",
                    w["normal"]]) == 0
from varlociraptor_tpu_torch.estimation.alignment_properties import (
    AlignmentProperties, HopParams,
)
props = AlignmentProperties.from_json(buf.getvalue())
props.hop_params = HopParams(*([[math.log(0.05)] * 4] * 4))
open(work + "/props.json", "w").write(props.to_json())
assert cli.run(["preprocess", "variants", w["fasta"], "--bam", w["tumor"],
                "--candidates", w["candidates"], "--output", work + "/t.obs",
                "--device", "cpu"]) == 0
from varlociraptor_tpu_torch.ops import pairhmm_column as phc
k4 = phc.positional_forward
k4_calls = []
phc.positional_forward = lambda *a: k4_calls.append(1) or k4(*a)
assert cli.run(["preprocess", "variants", w["fasta"], "--bam", w["tumor"],
                "--candidates", w["candidates"], "--output", work + "/t_hp.obs",
                "--alignment-properties", work + "/props.json",
                "--pairhmm-mode", "homopolymer", "--device", "cpu"]) == 0
from varlociraptor_tpu_torch.calling import preprocess as pp
workers = []
pp.worker_hook = workers.extend
assert cli.run(["preprocess", "variants", w["fasta"], "--bam", w["tumor"],
                "--candidates", w["candidates"], "--output", work + "/t_par.obs",
                "--threads", "2", "--device", "cpu"]) == 0
from varlociraptor_tpu_torch.calling.observations import ObservationReader
print("PREPROCESSED", len(ObservationReader(work + "/t.obs").read_window(100)[0]))
print("THREADS", len(ObservationReader(work + "/t_par.obs").read_window(100)[0]),
      "WORKERS", len(workers), sum(r["records"] for r in workers))
print("HOMOPOLYMER", len(ObservationReader(work + "/t_hp.obs").read_window(100)[0]),
      "K4", bool(k4_calls))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "varlociraptor_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
records = [l for l in open(work + "/calls.vcf") if not l.startswith("#")]
print("RECORDS", len(records))
"""


def test_cli_runs_with_jax_blocked(tmp_path):
    guard = str(ROOT / "scripts" / "torch_no_jax")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (guard, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT), str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RECORDS 40" in proc.stdout
    assert "PREPROCESSED 12" in proc.stdout
    assert "THREADS 12 WORKERS 2 12" in proc.stdout
    assert "HOMOPOLYMER 12 K4 True" in proc.stdout
    assert (tmp_path / "kept.vcf").exists()


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    tumor, normal, _ = synth_observation_files(tmp_path, n_loci=4, seed=2)
    out = tmp_path / "calls.vcf"
    with pytest.raises(RuntimeError, match="is_available"):
        cli.run(["call", "variants", "tumor-normal", "--tumor", tumor,
                 "--normal", normal, "--device", "cuda", "--output", str(out)])
    assert not out.exists()
    w = synth_preprocess_world(tmp_path / "world", seed=3, genome_len=8000,
                               coverage=4.0, n_germline=4, n_somatic=3, n_decoy=3)
    obs = tmp_path / "t.obs"
    with pytest.raises(RuntimeError, match="is_available"):
        cli.run(["preprocess", "variants", w["fasta"], "--bam", w["tumor"],
                 "--candidates", w["candidates"], "--output", str(obs),
                 "--device", "cuda"])
    assert not obs.exists()
    # the CLI's default device is the card
    args = cli.build_parser().parse_args(
        ["call", "variants", "tumor-normal", "--tumor", "t", "--normal", "n",
         "--output", "o"])
    assert args.device == "cuda"
    args = cli.build_parser().parse_args(
        ["preprocess", "variants", "ref.fa", "--bam", "b", "--candidates", "c",
         "--output", "o"])
    assert args.device == "cuda"


_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M)
_JAX_PACKAGE_IMPORT = re.compile(r"^\s*(import|from)\s+varlociraptor_tpu(\.|\s|$)", re.M)
_PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + [
    "chip_smoke.py", "scripts/torch_k1_variants.py", "scripts/torch_k3_variants.py",
    "scripts/torch_e2e_ab.py", "scripts/torch_no_jax/sitecustomize.py"]


@pytest.mark.parametrize("path", _PORT_FILES)
def test_no_jax_import_in_the_port(path):
    assert not _JAX_IMPORT.search((ROOT / path).read_text()), path


@pytest.mark.parametrize("path", _PORT_FILES)
def test_no_jax_package_import_in_the_port(path):
    assert not _JAX_PACKAGE_IMPORT.search((ROOT / path).read_text()), path
