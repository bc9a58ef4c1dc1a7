"""The port's preprocess on the wavefront routes against the JAX package's.

The tumor of the tiny seeded world of ``tests/test_torch_preprocess.py``
(``bench_utils.synth_preprocess_world``: 20 kb, 6x, 50 candidates) goes
through ``preprocess`` of both packages (what ``preprocess variants`` runs)
with the same switches, 64 loci per pair-HMM call as on the card (the
CLIs' CPU default of one locus per call runs ~50 small XLA scans on the
JAX side, which take minutes when the test shares the machine):

* ``VLT_HOP_STATES=1 --pairhmm-mode homopolymer`` with hop rates of 0.05
  for every base (the 20 kb world holds too few homopolymer indels for the
  estimate's MLE): the hop-state wavefront, JAX's ``_forward_hop_impl`` and
  the port's ``hop_forward`` (its plain version on the CPU);
* ``VLT_PALLAS_PAIRHMM=0``: the banded wavefront, ``_forward_impl`` and
  ``banded_forward``.

The JAX side runs with ``VLT_NATIVE_PAIRHMM=0`` (its wavefronts, not its
native host forward).  Tolerance (``compare.compare_observation_files``):
the same records and read counts, every field the pair-HMM does not touch
identical, prob_alt, prob_ref and prob_missed_allele within 5e-4 *
max(1, |x|) plus one float16 step, or both below -30.  Measured: every value
identical (largest relative error 0.0), none below -30.
"""

import math

import pytest
import torch

from varlociraptor_tpu.calling.preprocess import PreprocessOptions as JaxOptions
from varlociraptor_tpu.calling.preprocess import preprocess as jax_preprocess
from varlociraptor_tpu.estimation.alignment_properties import (
    AlignmentProperties,
    HopParams,
    estimate,
)
from varlociraptor_tpu.io.bam import BamReader
from varlociraptor_tpu.io.fasta import FastaBuffer
from varlociraptor_tpu_torch.bench_utils import synth_preprocess_world
from varlociraptor_tpu_torch.calling.preprocess import PreprocessOptions, preprocess
from varlociraptor_tpu_torch.compare import compare_observation_files
from varlociraptor_tpu_torch.convert import alignment_properties_from_jax
from varlociraptor_tpu_torch.ops import pairhmm_column as phc
from varlociraptor_tpu_torch.ops import pairhmm_wavefront as pwf

TINY_WORLD = dict(seed=1, genome_len=20_000, coverage=6.0, n_germline=16, n_somatic=12,
                  n_decoy=12, n_snv=10)


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
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("hop_world")
    w = synth_preprocess_world(d, **TINY_WORLD)
    props = estimate(BamReader(w["normal"]), reference=FastaBuffer(w["fasta"]))
    props.hop_params = HopParams(*([[math.log(0.05)] * 4] * 4))
    w["props"] = props.to_json()
    return w


def _counting(monkeypatch, module, names):
    calls = []
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(module, name, counted)
        # the wavefront route reaches its wrappers through WRAPPERS
        for key, wrapper in getattr(module, "WRAPPERS", {}).items():
            if wrapper is fn:
                monkeypatch.setitem(module.WRAPPERS, key, counted)
    return calls


@pytest.mark.parametrize("switch,mode,wrapper", [
    ("VLT_HOP_STATES", "homopolymer", "hop_forward"),
    ("VLT_PALLAS_PAIRHMM", "exact", "banded_forward"),
], ids=["hop_states", "banded_wavefront"])
def test_preprocess_matches_jax(world, tmp_path, monkeypatch, switch, mode, wrapper):
    monkeypatch.setenv("VLT_NATIVE_PAIRHMM", "0")
    monkeypatch.setenv("VLT_HOP_STATES", "1" if switch == "VLT_HOP_STATES" else "0")
    if switch == "VLT_PALLAS_PAIRHMM":
        monkeypatch.setenv("VLT_PALLAS_PAIRHMM", "0")
    else:
        monkeypatch.delenv("VLT_PALLAS_PAIRHMM", raising=False)
    wavefront = _counting(monkeypatch, pwf, ["banded_forward", "positional_banded_forward",
                                             "hop_forward"])
    column = _counting(monkeypatch, phc, ["exact_forward", "general_forward",
                                          "positional_forward"])
    ref, got = tmp_path / "jax.obs", tmp_path / "torch.obs"
    props = AlignmentProperties.from_json(world["props"])
    n_jax = jax_preprocess(world["candidates"], world["tumor"], world["fasta"], str(ref),
                           sample_name="tumor", alignment_properties=props,
                           options=JaxOptions(log_mode="silent", pairhmm_mode=mode,
                                              device_chunk=64))
    n_port = preprocess(world["candidates"], world["tumor"], world["fasta"], str(got),
                        sample_name="tumor",
                        alignment_properties=alignment_properties_from_jax(props),
                        options=PreprocessOptions(log_mode="silent", pairhmm_mode=mode,
                                                  device_chunk=64),
                        device="cpu")
    assert n_jax == n_port == world["n_candidates"]
    problems, info = compare_observation_files(ref, got)
    assert not problems, problems
    assert info["records"] == world["n_candidates"] and info["reads"] > 100
    assert set(wavefront) == {wrapper} and not column
    print(switch, info)
