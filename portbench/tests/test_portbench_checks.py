"""The check that decides ``correct``, on the CPU at a test's size: the port
agrees with the plain reference; the control (the reference in bfloat16 in
the port's place) fails a limit; a run whose timed path is broken
underneath comes out not correct, once for each fault the cell can have (an
answer altered where it is made; half of the batch left out); and the FDR
rule on calls whose answer is known.  The harness's look for a card is
skipped (``harness.run_cell`` on "cpu")."""

from __future__ import annotations

import math

import pytest
import torch

from portbench.reference import call_model, check_call, control
from portbench.tests.tiny import run_tiny, tiny_cell

CELL = "tumor_normal.call"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_agrees_with_the_reference(tmp_path):
    out, checks = run_tiny(CELL, tmp_path)
    assert out["correct"], checks
    assert list(out)[-1] == "checks" and out["attempted"] > 0
    for name, value, limit in checks:
        assert value <= limit, name


def test_control_fails_a_limit():
    _, _, config, traffic = tiny_cell(CELL)
    got = control.control(config, traffic, 7)
    assert any(got[n] > check_call.LIMITS[n] for n in got), got


def _alter_k1(monkeypatch):
    from varlociraptor_tpu_torch.ops import ll_classes

    plain = ll_classes.ll_classes

    def k1(*args):
        out = plain(*args).clone()
        out[:, ::2] += 1.0  # every other class: moves the likelihood's shape
        return out

    monkeypatch.setattr(ll_classes, "ll_classes", k1)


def _drop_half_of_each_window(monkeypatch):
    from varlociraptor_tpu_torch.calling.observations import ObservationReader

    read = ObservationReader.read_window

    def half(self, n):
        got = read(self, n)
        if got is None:
            return None
        variants, counts, cols, depth = got
        h = max(1, len(variants) // 2)
        return variants[:h], counts[:h], cols.slice(0, int(counts[:h].sum())), depth[:h]

    monkeypatch.setattr(ObservationReader, "read_window", half)


FAULTS = {"answer_altered": _alter_k1, "half_left_out": _drop_half_of_each_window}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    out, checks = run_tiny(CELL, tmp_path)
    assert out["correct"] is False, checks


def _vcf(path, probs):
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ttumor"]
    for i, p in enumerate(probs):
        phred = "inf" if p == 0 else f"{-10 * math.log10(p):.4f}"
        lines.append(f"chr1\t{i + 1}\t.\tA\tC\t.\t.\tPROB_SOMATIC_TUMOR={phred}\tAF\t0.5")
    path.write_text("\n".join(lines) + "\n")
    return path


def test_fdr_rule_keeps_the_largest_set_under_alpha(tmp_path):
    # error probabilities 0.01, 0.02, 0.05, 0.3, 1: the running means are
    # 0.01, 0.015, 0.0267, 0.095, 0.276, so at 0.05 the first three stay
    vcf = _vcf(tmp_path / "c.vcf", [0.99, 0.98, 0.95, 0.7, 0.0])
    assert check_call.fdr_keep(vcf, ["somatic_tumor"], 0.05) == {
        (1, "A", "C"), (2, "A", "C"), (3, "A", "C")}
    assert check_call.fdr_keep(vcf, ["somatic_tumor"], 0.001) == set()


def test_observable_frequencies_of_a_range():
    half_open = call_model.Spectrum.parse("]0.0,0.5[")
    lo, hi = call_model._observable(half_open, 20)
    assert lo == pytest.approx(1 / 20) and hi == pytest.approx(9 / 20)
    lo, hi = call_model._observable(half_open, 5)  # below 10 reads: as written
    assert (lo, hi) == (0.0, 0.5)
