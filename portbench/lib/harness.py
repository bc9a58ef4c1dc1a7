"""One run of one cell: set-up, the measured window, the check, the result.

The cell, its configuration and its traffic mix come from ``BENCHMARK.json``
at the checkout's root, ``portbench/configs/<config>.json`` (the entry's
``file``) and ``portbench/traffic/<traffic>.json``; the traffic's
``stage`` names the driver (``portbench/lib/stage_<stage>.py``), its
``end_to_end`` maps each end-to-end metric of the cell besides ``setup_s``
to a quantity of the window (:data:`QUANTITIES`).  A per-layer
metric is read by ``portbench/metrics/<name>.py``'s ``read(record)``,
which returns None when the record holds nothing for it.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number with its limit),
which the last lines of standard error repeat.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

PB = Path(__file__).resolve().parent.parent
ROOT = PB.parent
REFUSED = ("jax", "jaxlib", "flax", "varlociraptor_tpu")

# the window's quantities that a traffic file may name as end-to-end
# metrics: f(record) -> value, or None where the run cannot read it (no card)
QUANTITIES = {
    "units_per_s": lambda rec: rec["units"] / rec["window_s"],
    "device_ms_per_1k_units": lambda rec: (1e3 * rec["busy_s"] / (rec["units"] / 1e3)
                                           if rec.get("busy_s") else None),
}


def process_start():
    """Wall-clock time at which this process started (from /proc), or the
    import time of this module where /proc cannot tell."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start / ticks)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def refused_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)


def fail(msg, code=2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def load_cell(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench, cell):
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell["name"] in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def read_metric(name, record):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", PB / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description="one run of one portbench cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    try:
        bench, cell, config, traffic = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        return fail(f"cannot load the cell: {e}")
    threads = traffic.get("host_threads")
    if threads:
        # the load of one process with few threads: set before torch and the
        # program's native library read them
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "VLT_NATIVE_THREADS"):
            os.environ[var] = str(threads)
    cpus = traffic.get("host_cpus")
    if cpus:
        # a fixed set of CPUs, the first the process may use: steadier
        # than the scheduler's choice on a shared host
        os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:int(cpus)])
    import torch

    if threads:
        torch.set_num_threads(int(threads))

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['chips']} CUDA device(s) needed, "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    try:
        import varlociraptor_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the port does not import: {e}")
    imported_s = time.time() - t_start
    e2e, layer = cell_metrics(bench, cell)
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        out, checks = run_cell(cell, config, traffic, e2e, layer, args.seed, args.seconds,
                               bool(args.trace), work, t_start, "cuda")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if out is None:
        return fail(f"modules of JAX or the JAX package loaded: {checks}", 3)
    out["timings"] = {"import_s": imported_s, **out["timings"]}
    print(f"portbench: seconds {json.dumps(out['timings'])}", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r}){'' if v <= lim else '  FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def run_cell(cell, config, traffic, e2e, layer, seed, seconds, traced, work, t_start,
             device):
    """Set-up, window and check of one run on ``device``: (result, checks),
    or (None, the refused modules found) where JAX or the JAX package has
    loaded by the window's close or the check's end."""
    import gc

    import torch

    from . import trace

    stage = importlib.import_module(f"portbench.lib.stage_{traffic['stage']}").Stage(
        config, traffic, seed, work, device)
    on_card = device != "cpu"
    stage.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    if traced or on_card:
        from torch.profiler import ProfilerActivity, profile

        # untraced, the profiler records the device's activity alone: the
        # device seconds of the end-to-end metrics
        acts = (([ProfilerActivity.CPU] if traced else [])
                + ([ProfilerActivity.CUDA] if on_card else []))
        with profile(activities=acts) as prof:
            with trace.span("window"):
                rec = stage.window(seconds, traced)
        rec.update(trace.reduce(prof) if traced else {"busy_s": trace.device_busy_s(prof)})
        del prof
    else:
        rec = stage.window(seconds, False)
    memory_peak = (max(torch.cuda.max_memory_allocated(i) for i in range(cell["chips"]))
                   if on_card else 0)
    if refused_modules():
        return None, refused_modules()
    stage.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = stage.check()
    timings = {**stage.timings, "check_s": time.perf_counter() - t}
    info = [c for c in checks if c[2] is None]
    checks = [c for c in checks if c[2] is not None]
    if on_card:
        from varlociraptor_tpu_torch import _build

        timings["kernel_build_s"] = _build.build_seconds
    if refused_modules():
        return None, refused_modules()
    if traced:
        metrics = {}
        for m in layer:
            v = read_metric(m["name"], rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **{name: QUANTITIES[q](rec)
                                         for name, q in traffic["end_to_end"].items()}}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e
                   if values[m["name"]] is not None}
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": cell["chips"], "memory_peak_bytes": memory_peak,
                  "power_limit_w": power_limit() if on_card else None}
    out = {"correct": all(v <= lim for _, v, lim in checks), "attempted": rec["units"],
           "failed": 0, "metrics": metrics, "device": device_rec}
    if traced:
        device_rec.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        out["breakdown"] = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}
    out["timings"] = timings
    out["reported"] = {name: v for name, v, _ in info}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out, checks
