#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch / CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (see ``portbench/README.md``).  The caches
of the program's kernels live at fixed paths inside the checkout
(``build/``); the run's inputs and outputs live in a directory under
``TMPDIR`` that it removes at its end.
"""

import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# set before torch loads: kernel caches at fixed paths of the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

from portbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
