"""Two ranks over torch.distributed (gloo, on the CPU), the port's
counterpart of tests/test_multihost.py.

One pair of spawned ranks serves the whole file.  Each rank starts with
torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK), under the no-JAX guard (scripts/torch_no_jax on PYTHONPATH) and
with a timeout of its own, builds ``distributed_mesh(["cpu"] * 4)`` (8 shards
in all) and:

* takes its 24-locus half of ``engine_inputs(48, depth 16, seed 11)`` through
  ``run_sharded``;
* gathers 3 (rank 0) and 5 (rank 1) float64 rows with ``all_gather_rows``;
* calls its region half of a small ``synth_observation_files`` set through
  ``call_generic(mesh=...)`` and filters its calls with
  ``control_fdr_sharded``.

The parent holds the rows to JAX's single-process ``engine.run`` at
tests/test_multihost.py's tolerances (MAP AF at compare.AF_TOL, see below)
and to the port's own single-process run bit for bit, the gathered arrays
to each other (bit for bit), the two call files together to a
single-process no-mesh call of the same loci, and the union of the kept
sets to ``control_fdr`` on that call file.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from varlociraptor_tpu import bench_utils as jbu
from varlociraptor_tpu_torch import bench_utils as tbu
from varlociraptor_tpu_torch.bench_utils import region_shards, synth_observation_files
from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
from varlociraptor_tpu_torch.compare import AF_TOL, compare_vcf_text, vcf_record_keys
from varlociraptor_tpu_torch.filtration.fdr import control_fdr
from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario

ROOT = Path(__file__).resolve().parent.parent
GUARD = ROOT / "scripts" / "torch_no_jax"
L, HALF = 48, 24
CALL_LOCI = 160
RANK_TIMEOUT_S = 240
FDR = dict(events=["somatic_tumor"], alpha=0.05)
ROWS = {
    0: np.array([[1.5, -2.25], [3.0, 4.5], [-1.0, 0.125]], dtype=np.float64),
    1: np.arange(10, dtype=np.float64).reshape(5, 2) / 3.0,
}

_RANK = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
args = json.loads(sys.argv[2])
rank = int(os.environ["RANK"])
import numpy as np
from varlociraptor_tpu_torch.bench_utils import engine_inputs, tumor_normal_engine
from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
from varlociraptor_tpu_torch.filtration.fdr import control_fdr_sharded
from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
from varlociraptor_tpu_torch.parallel.sharding import (
    all_gather_rows, distributed_mesh, run_sharded,
)

mesh = distributed_mesh(["cpu"] * 4)
assert (mesh.backend, mesh.world_size, mesh.rank, mesh.size) == ("gloo", 2, rank, 8), mesh
_, engine = tumor_normal_engine(device="cpu")
full = engine_inputs(engine, n_loci=args["L"], depth=16, seed=11)
h = args["HALF"]
out = run_sharded(engine, mesh, *[np.asarray(a)[rank * h:(rank + 1) * h] for a in full])
rows = np.asarray(args["rows"][rank], dtype=np.float64)
gathered = all_gather_rows(rows, mesh)
calls, kept = args["calls"][rank], args["kept"][rank]
obs = dict(zip(("tumor", "normal"), args["obs"][rank]))
n = call_generic(tumor_normal_scenario(0.75), obs, calls, CallOptions(), mesh=mesh,
                 device="cpu")
n_kept = control_fdr_sharded([calls], kept, mesh=mesh, **args["fdr"])
np.savez(args["out"][rank], posteriors=out["posteriors"], af=out["af"],
         marginal=out["marginal"], dphred=out["densities_dphred"], gathered=gathered)
blocked = [m for m in ("jax", "varlociraptor_tpu") if sys.modules.get(m, 0) is not None]
print("RANK", rank, "CALLED", n, "KEPT", n_kept, "BLOCKED", not blocked, flush=True)
import torch.distributed as dist
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU engine on one thread here and in the ranks: as fast at
    these sizes, and a fraction of the CPU beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    tumor, normal, _ = synth_observation_files(d / "obs", n_loci=CALL_LOCI, seed=7)
    shards = region_shards([tumor, normal], d, [CALL_LOCI // 2, CALL_LOCI // 2])
    args = {
        "L": L, "HALF": HALF, "fdr": FDR,
        "rows": [ROWS[0].tolist(), ROWS[1].tolist()],
        "obs": shards,
        "calls": [str(d / f"calls{r}.vcf") for r in (0, 1)],
        "kept": [str(d / f"kept{r}.vcf") for r in (0, 1)],
        "out": [str(d / f"rank{r}.npz") for r in (0, 1)],
    }
    port = str(_free_port())
    procs = []
    for rank in (0, 1):
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": port,
               "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": "2", "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   p for p in (str(GUARD), os.environ.get("PYTHONPATH")) if p)}
        env.pop("PYTEST_CURRENT_TEST", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, str(ROOT), json.dumps(args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank ran past {RANK_TIMEOUT_S} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return d, args, outs, (tumor, normal)


def test_ranks_ran_without_jax(ranks):
    _, _, outs, _ = ranks
    for rank, out in enumerate(outs):
        assert f"RANK {rank} CALLED {CALL_LOCI // 2} " in out, out[-2000:]
        assert "BLOCKED True" in out, out[-2000:]


def test_rank_rows_match_jax_single_process(ranks):
    _, args, _, _ = ranks
    _, engine = jbu.tumor_normal_engine()
    ref = engine.run(*jbu.engine_inputs(engine, n_loci=L, depth=16, seed=11))
    d0, d1 = (np.load(p) for p in args["out"])
    post = np.concatenate([d0["posteriors"], d1["posteriors"]])
    af = np.concatenate([d0["af"], d1["af"]])
    marg = np.concatenate([d0["marginal"], d1["marginal"]])
    dph = np.concatenate([d0["dphred"], d1["dphred"]])
    fin = np.isfinite(ref["posteriors"])
    assert np.array_equal(np.isfinite(post), fin)
    assert np.allclose(post[fin], ref["posteriors"][fin], atol=2e-3), np.max(
        np.abs(post[fin] - ref["posteriors"][fin]))
    # MAP AF: tests/test_multihost.py holds JAX to itself at 1e-5; the port
    # sums read log-likelihoods in float64 where JAX sums in float32, and is
    # held to JAX at compare.AF_TOL (ROADMAP C), and to its own
    # single-process run bit for bit
    assert np.allclose(af, ref["af"], rtol=0, atol=AF_TOL), np.max(np.abs(af - ref["af"]))
    _, te = tbu.tumor_normal_engine(device="cpu")
    own = te.run(*tbu.engine_inputs(te, n_loci=L, depth=16, seed=11))
    for k, v in (("posteriors", post), ("af", af), ("marginal", marg),
                 ("densities_dphred", dph)):
        assert np.array_equal(v, own[k]), k
    finm = np.isfinite(ref["marginal"])
    assert np.allclose(marg[finm], ref["marginal"][finm], atol=2e-3)
    same = dph != 32767
    assert np.array_equal(same, ref["densities_dphred"] != 32767)
    assert np.max(np.abs(dph[same].astype(int) - ref["densities_dphred"][same])) <= 1


def test_gathered_rows_identical_on_both_ranks(ranks):
    _, args, _, _ = ranks
    g0, g1 = (np.load(p)["gathered"] for p in args["out"])
    expected = np.concatenate([ROWS[0], ROWS[1]])
    assert g0.dtype == np.float64 and g0.shape == expected.shape
    assert g0.tobytes() == g1.tobytes() == expected.tobytes()


def test_region_calls_and_kept_sets_match_single_process(ranks):
    d, args, _, (tumor, normal) = ranks
    single = d / "single.vcf"
    call_generic(tumor_normal_scenario(0.75), {"tumor": tumor, "normal": normal},
                 str(single), CallOptions(), device="cpu")
    texts = [Path(p).read_text() for p in args["calls"]]
    joined = texts[0] + "".join(
        line for line in texts[1].splitlines(keepends=True) if not line.startswith("#"))
    problems, _ = compare_vcf_text(single.read_text(), joined)
    assert not problems, problems[:3]
    kept_single = d / "kept_single.vcf"
    n = control_fdr(str(single), str(kept_single), **FDR)
    kept = [k for p in args["kept"] for k in vcf_record_keys(Path(p).read_text())]
    assert kept == vcf_record_keys(kept_single.read_text())
    assert 0 < n == len(kept)
