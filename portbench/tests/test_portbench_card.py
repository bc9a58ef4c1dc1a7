"""Each cell, cut to a test's size, on the card: the port's kernels on the
timed path, ``correct`` true against the plain reference.

    python -m pytest portbench/tests -q -m cuda -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch

from portbench.lib import harness
from portbench.tests.tiny import tiny_cell

CELLS = ["tumor_normal.call"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    bench, entry, config, traffic = tiny_cell(cell)
    e2e, layer = harness.cell_metrics(bench, entry)
    out, checks = harness.run_cell(entry, config, traffic, e2e, layer, 20261018, 1.0, True,
                                   tmp_path, harness.process_start(), "cuda")
    assert out["correct"], checks
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
