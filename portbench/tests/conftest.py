"""pytest settings of the benchmark's own tests (``portbench/tests``):
the checkout's root on ``sys.path`` and the repository's ``cuda`` marker.
Nothing here imports JAX."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is false",
    )
