"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc``, one process per source,
all started together, and linked into one shared library with a plain C
interface, bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c varlociraptor_tpu_torch/csrc/<name>.cu -o <hash>/<name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \
         build/torch_kernels/<hash>/libvlt_torch_kernels.so <hash>/*.o

The output directory is keyed by a hash of the sources, so an edited kernel
is rebuilt and a clean checkout builds once.  A missing ``nvcc`` or a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIB_NAME = "libvlt_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process (None = cached)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash():
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc():
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "varlociraptor_tpu_torch cannot be built"
    )


def library_path():
    return BUILD_ROOT / _source_hash() / LIB_NAME


def build():
    """Compile ``csrc/*.cu`` unless the hashed library exists; return its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = out.with_name(f"{src.stem}.{os.getpid()}.o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-c", str(src), "-o", str(obj)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """The ctypes handle of the kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.vlt_ll_classes.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
            lib.vlt_ll_classes.restype = i
            # K2, K3: B, Xp, Yp, then the tile (lanes, rows)
            lib.vlt_pairhmm_exact.argtypes = [p] * 7 + [i] * 5 + [p]
            lib.vlt_pairhmm_exact.restype = i
            lib.vlt_pairhmm_general.argtypes = [p] * 7 + [i] * 5 + [p]
            lib.vlt_pairhmm_general.restype = i
            # K4: the [7] coef gives way to the four gap panels io, ie, do, de;
            # B, Xp, Yp and its tile
            lib.vlt_pairhmm_positional.argtypes = [p] * 10 + [i] * 5 + [p]
            lib.vlt_pairhmm_positional.restype = i
            # the wavefronts: flavour, 12 input pointers (null where the
            # flavour reads nothing), out, B, X, Y
            lib.vlt_pairhmm_wavefront.argtypes = [i] + [p] * 13 + [i] * 3 + [p]
            lib.vlt_pairhmm_wavefront.restype = i
            # the grid contraction: F, S, groups, masks, out; L, B, Gv, Gu,
            # NB, K, G, the group width; F's and S's strides
            lib.vlt_lse_contract.argtypes = [p] * 5 + [i] * 8 + [ctypes.c_longlong] * 8 + [p]
            lib.vlt_lse_contract.restype = i
            # the star l2fc integral: pa, wa, pb, wb, lm, rp, out; L, B, Ga,
            # Gb, Gp; the strides of pa, wa, pb, wb, lm and rp
            lib.vlt_lfc_star.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_longlong] * 17 + [p]
            lib.vlt_lfc_star.restype = i
            # the event and MAP / AFD pass: the head (bv, gates, n_art, its
            # log where n_art is null, the event and artifact tables, L, B,
            # NB, E, S, the host table of the samples, five outputs) and the
            # tail (the host tables of the samples and of the components, L,
            # NB, marginal, af, the deci-PHRED and index outputs and widths)
            lib.vlt_assemble_head.argtypes = (
                [p, p, p, ctypes.c_float, p, p, p, p, i, p] + [i] * 5 + [p] * 6 + [p])
            lib.vlt_assemble_head.restype = i
            lib.vlt_assemble_tail.argtypes = [p, i, p, i, i, i, p, p, p, i, p, i, p]
            lib.vlt_assemble_tail.restype = i
            _lib = lib
        return _lib
