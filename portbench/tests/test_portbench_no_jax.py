"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``varlociraptor_tpu``, compared by whole top-level name (the port,
``varlociraptor_tpu_torch``, begins with the JAX package's name); and the
command prints no result where it cannot measure."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from portbench.lib import harness

REFUSED = {"jax", "jaxlib", "flax", "varlociraptor_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_under_portbench_imports_jax():
    files = list(harness.PB.rglob("*.py"))
    assert len(files) > 15
    bad = [(str(p), m) for p in files for m in _imports(p) if m.split(".")[0] in REFUSED]
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    files = list((harness.PB / "reference").rglob("*.py"))
    assert files
    assert not [(str(p), m) for p in files for m in _imports(p)
                if m.split(".")[0] == "varlociraptor_tpu_torch"]


GUARD = """
import importlib.abc, sys
REFUSED = {"jax", "jaxlib", "flax", "varlociraptor_tpu"}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {name}")
sys.meta_path.insert(0, Refuse())
import tempfile, torch
from pathlib import Path
torch.set_num_threads(2)
from portbench.tests.tiny import run_tiny
import portbench.reference.control
with tempfile.TemporaryDirectory() as d:
    out, checks = run_tiny("tumor_normal.call", Path(d), traced=True)
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in REFUSED))
print("CORRECT", out["correct"])
"""


def test_a_run_loads_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(harness.ROOT)
    p = subprocess.run([sys.executable, "-c", GUARD], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "LOADED []" in p.stdout and "CORRECT True" in p.stdout, p.stdout


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "tumor_normal.call", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    import torch

    if not torch.cuda.is_available():
        p = _run(harness.ROOT)
        assert p.returncode != 0 and p.stdout.strip() == ""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "portbench:" in p.stderr
    json.loads((tmp_path / "BENCHMARK.json").read_text())
