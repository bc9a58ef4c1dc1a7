"""The cell at a size a CPU test run can hold."""

from __future__ import annotations

import copy

from portbench.lib import harness

# the configuration's and the traffic's keys changed for a test
TINY = {"tumor_normal.call": {"genome_len": 300_000, "check_loci": 100}}


def tiny_cell(name):
    """(bench, cell, config, traffic) of the cell ``name`` cut to a test's
    size: a few hundred loci."""
    bench, cell, config, traffic = harness.load_cell(name)
    config, traffic = copy.deepcopy(config), dict(traffic)
    cut = TINY[name]
    config["genome_len"] = cut["genome_len"]
    traffic["check_loci"] = cut["check_loci"]
    return bench, cell, config, traffic


def run_tiny(name, work, seed=20261018, seconds=0.5, traced=False):
    """One run of the tiny cell on the CPU: (result, checks)."""
    bench, cell, config, traffic = tiny_cell(name)
    e2e, layer = harness.cell_metrics(bench, cell)
    return harness.run_cell(cell, config, traffic, e2e, layer, seed, seconds, traced, work,
                            harness.process_start(), "cpu")
