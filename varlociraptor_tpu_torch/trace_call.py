"""Where the call stage's and preprocess's time goes on one card.

    python -m varlociraptor_tpu_torch.trace_call [--out DIR] [--loci N] [WHAT ...]

WHAT picks among engine, cli, preprocess and modes (default: all).  Five
measurements, each printed as one JSON line:

  engine   one ``PosteriorEngine.run`` at the bench shape (32768 loci, depth
           64, resolution 0.01) under ``torch.profiler``: device time by
           kernel, the device's busy share of the call's wall time, and the
           wall time of a plain call for comparison;
  cli      ``call variants tumor-normal --device cuda`` on N synthetic loci
           under ``torch.profiler``: the device's busy share of the wall,
           and the program's spans and counters (``tracing.summary``): each
           span's self and total ms per 1,000 loci, each counter's total;
  preprocess
           ``preprocess variants --device cuda`` of the tumor of a 500 kb,
           30x ``synth_preprocess_world`` (500 indel candidates) under
           ``torch.profiler``: the device's busy share, device time by kernel;
  preprocess_host
           the same run under ``cProfile``: host time by function;
  modes    one ``PosteriorEngine.run`` of the l2fc engine (8192 loci) and of
           the three-sample contamination cycle (2048 loci), depth 64, under
           ``torch.profiler`` with shapes: the device's busy share, kernels
           launched, device time by kernel and by operator and input shape.

The engine's Chrome trace and the full tables go to DIR (default
build/trace_call/report); the synthetic files and calls to build/trace_call.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import tracing


def _device_events(prof):
    return [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"
    ]


def _device_busy_s(prof):
    """Seconds in which the card ran a kernel or a copy (union of intervals)."""
    busy, end = 0.0, -1.0
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in _device_events(prof)):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6


def _device_table(prof, top=15):
    """[(kernel or copy, device ms, launches)] summed by name, largest first."""
    by = {}
    for e in _device_events(prof):
        us, n = by.get(e.name, (0.0, 0))
        by[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    rows = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    return [{"name": k[:90], "ms": us / 1e3, "calls": n} for k, (us, n) in rows]


def trace_engine(out_dir):
    from .bench_utils import engine_inputs, tumor_normal_engine

    _, eng = tumor_normal_engine(resolution=0.01, device="cuda")
    inputs = engine_inputs(eng, n_loci=32768, depth=64, seed=0)
    eng.run(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(*inputs)
    plain_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(*inputs)
        wall_s = time.perf_counter() - t0
    prof.export_chrome_trace(str(out_dir / "engine_trace.json"))
    (out_dir / "engine_table.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    )
    busy = _device_busy_s(prof)
    return {
        "phase": "engine", "n_loci": 32768, "wall_s": wall_s,
        "plain_wall_s": plain_s, "device_busy_s": busy,
        "device_busy_share": busy / wall_s, "top_device": _device_table(prof),
    }


def _op_shape_table(prof, top=12):
    """[(operator, input shapes, own device ms, calls)] of the operators
    that ran on the card, grouped by input shape, largest first."""
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.input_shapes:
            rows.append({"op": e.key, "shapes": str(e.input_shapes)[:120],
                         "ms": us / 1e3, "calls": e.count})
    return sorted(rows, key=lambda r: -r["ms"])[:top]


def trace_modes(out_dir):
    from .bench_utils import cyclic_engine, engine_inputs, l2fc_engine

    lines = []
    for name, eng, n_loci in (("l2fc", l2fc_engine(), 8192),
                              ("cyclic", cyclic_engine(), 2048)):
        inputs = engine_inputs(eng, n_loci=n_loci, depth=64, seed=0)
        eng.run(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(*inputs)
        plain_s = time.perf_counter() - t0
        eng.loop_steps = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            eng.run(*inputs)
            wall_s = time.perf_counter() - t0
        (out_dir / f"modes_{name}_table.txt").write_text(
            prof.key_averages(group_by_input_shape=True).table(
                sort_by="self_device_time_total", row_limit=60)
        )
        busy = _device_busy_s(prof)
        kernels = [e for e in _device_events(prof) if "Memcpy" not in e.name
                   and "Memset" not in e.name]
        lines.append({
            "phase": "modes", "mode": name, "n_loci": n_loci, "wall_s": wall_s,
            "plain_wall_s": plain_s, "loop_steps": eng.loop_steps,
            "device_busy_s": busy, "device_busy_share": busy / wall_s,
            "kernels_launched": len(kernels),
            "kernel_mean_us": sum(e.time_range.end - e.time_range.start
                                  for e in kernels) / max(1, len(kernels)),
            "top_device": _device_table(prof, 10),
            "top_op_shapes": _op_shape_table(prof),
        })
    return lines


def trace_cli(work, n_loci):
    from . import cli
    from .bench_utils import synth_observation_files

    tumor, normal, _ = synth_observation_files(work, n_loci=n_loci, seed=0)
    argv = ["call", "variants", "tumor-normal", "--tumor", tumor, "--normal",
            normal, "--purity", "0.75", "--device", "cuda", "--output",
            str(work / "calls.vcf")]
    cli.run(argv)  # warm-up: kernel library, engine tables, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0, t0_ns = time.perf_counter(), time.time_ns()
        cli.run(argv)
        torch.cuda.synchronize()
        wall_s, t1_ns = time.perf_counter() - t0, time.time_ns()
    busy = _device_busy_s(prof)
    spans = tracing.summary(t0_ns, t1_ns)
    per_1k = 1e3 / (n_loci / 1e3)
    return {
        "phase": "cli", "n_loci": n_loci, "wall_s": wall_s,
        "loci_per_s": n_loci / wall_s, "device_busy_s": busy,
        "device_busy_share": busy / wall_s, "top_device": _device_table(prof, 8),
        "spans_ms_per_1k_loci": {
            k: {"self": v["self_s"] * per_1k, "total": v["total_s"] * per_1k, "n": v["n"]}
            for k, v in spans["spans"].items()},
        "counters": spans["counters"], "dropped": spans["dropped"],
    }


def _top_self(stats, n=15):
    own = sorted(
        ((f"{Path(k[0]).name}:{k[1]}:{k[2]}", v[2]) for k, v in stats.stats.items()),
        key=lambda x: -x[1],
    )[:n]
    return [{"fn": f, "s": s} for f, s in own]


def trace_preprocess(out_dir, work):
    from . import cli
    from .bench_utils import synth_preprocess_world

    w = synth_preprocess_world(work / "world", seed=0, genome_len=500_000,
                               n_germline=250, n_somatic=125, n_decoy=125)
    props = work / "props.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.run(["estimate", "alignment-properties", w["fasta"], "--bam", w["normal"]])
    props.write_text(buf.getvalue())
    argv = ["preprocess", "variants", w["fasta"], "--bam", w["tumor"], "--candidates",
            w["candidates"], "--alignment-properties", str(props), "--output",
            str(work / "tumor.obs"), "--device", "cuda"]
    with redirect_stderr(io.StringIO()):
        cli.run(argv)  # warm-up: kernel library, allocator
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cli.run(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        prof_host = cProfile.Profile()
        t0 = time.perf_counter()
        prof_host.runcall(cli.run, argv)
        host_wall = time.perf_counter() - t0
    busy = _device_busy_s(prof)
    buf = io.StringIO()
    stats = pstats.Stats(prof_host, stream=buf).sort_stats("cumulative")
    stats.print_stats(80)
    (out_dir / "preprocess_host_profile.txt").write_text(buf.getvalue())
    n = w["n_candidates"]
    return [
        {"phase": "preprocess", "candidates": n, "wall_s": wall_s,
         "loci_per_s": n / wall_s, "device_busy_s": busy,
         "device_busy_share": busy / wall_s, "top_device": _device_table(prof, 8)},
        {"phase": "preprocess_host", "candidates": n, "wall_s_under_cprofile": host_wall,
         "top_self_s": _top_self(stats)},
    ]


MEASUREMENTS = ["engine", "cli", "preprocess", "modes"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/trace_call/report")
    ap.add_argument("--loci", type=int, default=20000)
    ap.add_argument("what", nargs="*", choices=MEASUREMENTS)
    args = ap.parse_args(argv)
    what = args.what or MEASUREMENTS
    if not torch.cuda.is_available():
        print("trace_call: needs a CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path("build") / "trace_call"
    work.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    if "engine" in what:
        print(json.dumps(trace_engine(out_dir)), flush=True)
    if "cli" in what:
        print(json.dumps(trace_cli(work, args.loci)), flush=True)
    if "preprocess" in what:
        for line in trace_preprocess(out_dir, work):
            print(json.dumps(line), flush=True)
    if "modes" in what:
        for line in trace_modes(out_dir):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
