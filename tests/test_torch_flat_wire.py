"""The columnar caller's ``flat`` wire and the call stage's dispatch depth.

300 synthetic tumor/normal loci (``bench_utils.synth_observation_files``,
the files of ``tests/test_torch_call.py``) go through ``call_generic`` with
``wire_mode = "flat"`` (``PosteriorEngine.run_flat``: flat observation rows
scattered into the panels on the device):

* in the port, the calls VCF is byte-identical to the port's ``wire``
  route (the same engine on the same observations);
* against the JAX package's ``flat`` route, the VCFs agree under
  ``compare.compare_vcf_text`` (numbers within 1.1e-4 * max(1, |x|), the
  1-ulp PHRED rule of ROADMAP; every other byte identical), as the port's
  ``wire`` agrees with JAX's (``tests/test_torch_call.py``).

``run_flat`` drops rows indexed past the panels (the padding) and equals
``run_compact`` on the panels its rows scatter into.  The dispatch depth
(``VLT_DISPATCH_DEPTH``: windows in flight while the drain thread writes)
changes no byte of the VCF.
"""

import numpy as np
import pytest
import torch

from varlociraptor_tpu.calling import fastcall as jfastcall
from varlociraptor_tpu.calling.call import CallOptions as JaxCallOptions
from varlociraptor_tpu.calling.call import call_generic as jax_call_generic
from varlociraptor_tpu.grammar.scenario import tumor_normal_scenario as jax_tn_scenario
from varlociraptor_tpu_torch.bench_utils import synth_observation_files
from varlociraptor_tpu_torch.calling import fastcall
from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
from varlociraptor_tpu_torch.compare import compare_vcf_text, vcf_record_keys
from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario
from varlociraptor_tpu_torch.ops.posterior import PosteriorEngine

N_LOCI = 300


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain torch versions run thousands of small
    parallel regions per call, which stall for seconds each when the test
    shares a busy machine (xdist's other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    d = tmp_path_factory.mktemp("flat")
    tumor, normal, _ = synth_observation_files(d / "obs", n_loci=N_LOCI, seed=0)
    return d, {"tumor": tumor, "normal": normal}


def _port_call(monkeypatch, obs, path, mode, batch=None):
    monkeypatch.setattr(fastcall.ColumnarCaller, "wire_mode", mode)
    opts = CallOptions() if batch is None else CallOptions(batch_size=batch)
    n = call_generic(tumor_normal_scenario(0.75), obs, str(path), opts, device="cpu")
    assert n == N_LOCI
    return path.read_bytes()


def test_flat_wire_matches_wire_and_jax(obs, monkeypatch):
    d, files = obs
    engines = []
    run_flat = PosteriorEngine.run_flat

    def counted(self, *args, **kwargs):
        engines.append(args[4:6])  # (L, D) of each window
        return run_flat(self, *args, **kwargs)

    monkeypatch.setattr(PosteriorEngine, "run_flat", counted)
    flat = _port_call(monkeypatch, files, d / "flat.vcf", "flat", batch=64)
    # 64-locus windows: their flat axes are padded to the 4096-row bucket
    assert len(engines) > 1, "the flat route did not run in every window"
    assert flat == _port_call(monkeypatch, files, d / "wire.vcf", "wire", batch=64)
    monkeypatch.setattr(jfastcall.ColumnarCaller, "wire_mode", "flat")
    # one window on the JAX side (a program per window shape); the engine
    # computes each locus apart from its window
    jax_call_generic(jax_tn_scenario(0.75), files, str(d / "jax.flat.vcf"), JaxCallOptions())
    assert len(vcf_record_keys(flat.decode())) == N_LOCI
    problems, _ = compare_vcf_text((d / "jax.flat.vcf").read_text(), flat.decode())
    assert not problems, problems[:3]


def test_unknown_wire_mode_raises(obs, monkeypatch):
    d, files = obs
    monkeypatch.setattr(fastcall.ColumnarCaller, "wire_mode", "flat2")
    with pytest.raises(ValueError, match="'wire', 'flat' and 'panels'"):
        call_generic(tumor_normal_scenario(0.75), files, str(d / "x.vcf"), CallOptions(),
                     device="cpu")


def test_run_flat_matches_run_compact():
    """``run_flat`` on flat rows (with padding rows) equals ``run_compact``
    on the dense panels they scatter into."""
    from varlociraptor_tpu_torch.bench_utils import tumor_normal_engine
    from varlociraptor_tpu_torch.ops.compact_obs import N_CF, N_CU

    _, engine = tumor_normal_engine(resolution=0.1, purity=0.75, device="cpu")
    rng = np.random.default_rng(3)
    L, S, D, Bc = 6, 2, 8, 4
    counts = rng.integers(0, D + 1, (L, S))
    mask = np.arange(D)[None, None, :] < counts[:, :, None]
    f16 = np.zeros((L, S, D, N_CF), np.float16)
    u8 = np.zeros((L, S, D, N_CU), np.uint8)
    hil = np.full((L, S, D), -1, np.int8)
    n = int(mask.sum())
    f16[mask] = np.log(rng.uniform(0.01, 0.99, (n, N_CF))).astype(np.float16)
    u8[mask] = rng.integers(0, 2, (n, N_CU))
    hil[mask] = rng.integers(-1, 3, n)
    row = np.nonzero(mask.reshape(-1))[0].astype(np.int32)
    pad = 5
    row_p = np.concatenate([row, np.full(pad, L * S * D, np.int32)])
    f16f = np.concatenate([f16.reshape(-1, N_CF)[row], np.ones((pad, N_CF), np.float16)])
    u8f = np.concatenate([u8.reshape(-1, N_CU)[row], np.ones((pad, N_CU), np.uint8)])
    hilf = np.concatenate([hil.reshape(-1)[row], np.ones(pad, np.int8)])
    sm = np.tile(np.arange(Bc, dtype=np.int32), (L, 1))
    sa = np.ones((L, Bc), bool)
    bg = np.ones((L, engine.n_branches), bool)
    pa = np.full(L, -3.0, np.float32)
    fr = np.full(L, 0.5, np.float32)
    hal = np.zeros(L, bool)
    from varlociraptor_tpu_torch.evidence.observation import HOMOPOLYMER_NONE

    hil[~mask] = HOMOPOLYMER_NONE
    got = engine.run_flat(f16f, u8f, hilf, row_p, L, D, sm, sa, bg, pa, fr, hal)
    ref = engine.run_compact(f16, u8, hil, mask, sm, sa, bg, pa, fr, hal)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_dispatch_depth_keeps_the_vcf(obs, monkeypatch):
    """One and four 64-locus windows in flight write the same VCF."""
    d, files = obs
    vcfs = []
    for depth in ("1", "4"):
        monkeypatch.setenv("VLT_DISPATCH_DEPTH", depth)
        vcfs.append(_port_call(monkeypatch, files, d / f"depth{depth}.vcf", "wire", batch=64))
    assert vcfs[0] == vcfs[1]
