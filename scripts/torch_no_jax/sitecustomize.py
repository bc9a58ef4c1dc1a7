"""Block ``jax``, ``jaxlib`` and the JAX package ``varlociraptor_tpu`` in a
Python process that starts with this directory on ``PYTHONPATH``.

Python imports ``sitecustomize`` at start-up, so the block holds in every
process that inherits the environment, the spawned workers of ``preprocess
variants --threads N`` included (an import hook installed by a parent
reaches none of its children).  ``chip_smoke.py`` and
``tests/test_torch_no_jax.py`` run the port so:

    PYTHONPATH=scripts/torch_no_jax python3 -m varlociraptor_tpu_torch ...

An import of a blocked package raises ImportError.  The installation's own
``sitecustomize.py``, which this one shadows, runs after the block.
"""

import importlib.util
import os
import sys

for _name in ("jax", "jaxlib", "varlociraptor_tpu"):
    sys.modules[_name] = None

_here = os.path.dirname(os.path.abspath(__file__))
for _entry in sys.path:
    _path = os.path.join(_entry or os.curdir, "sitecustomize.py")
    if os.path.abspath(_entry or os.curdir) != _here and os.path.isfile(_path):
        _spec = importlib.util.spec_from_file_location("_shadowed_sitecustomize", _path)
        _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
        break
