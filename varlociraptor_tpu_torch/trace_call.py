"""Where the call stage's and preprocess's time goes on one card.

    python -m varlociraptor_tpu_torch.trace_call [--out DIR] [--loci N]

Five measurements, each printed as one JSON line:

  engine   one ``PosteriorEngine.run`` at the bench shape (32768 loci, depth
           64, resolution 0.01) under ``torch.profiler``: device time by
           kernel, the device's busy share of the call's wall time, and the
           wall time of a plain call for comparison;
  cli      ``call variants tumor-normal --device cuda`` on N synthetic loci
           under ``torch.profiler``: the device's busy share of the wall;
  host     the same CLI run under ``cProfile``: host time by function;
  preprocess
           ``preprocess variants --device cuda`` of the tumor of a 500 kb,
           30x ``synth_preprocess_world`` (500 indel candidates) under
           ``torch.profiler``: the device's busy share, device time by kernel;
  preprocess_host
           the same run under ``cProfile``: host time by function.

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


def trace_cli(out_dir, work, n_loci):
    from . import cli
    from .bench_utils import synth_observation_files

    tumor, normal, _ = synth_observation_files(work, n_loci=n_loci, seed=0)
    argv = ["call", "variants", "tumor-normal", "--tumor", tumor, "--normal",
            normal, "--purity", "0.75", "--device", "cuda", "--output",
            str(work / "calls.vcf")]
    cli.run(argv)  # warm-up: kernel library, engine tables, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.run(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy = _device_busy_s(prof)
    prof_host = cProfile.Profile()
    t0 = time.perf_counter()
    prof_host.runcall(cli.run, argv)
    host_wall = time.perf_counter() - t0
    buf = io.StringIO()
    stats = pstats.Stats(prof_host, stream=buf).sort_stats("cumulative")
    stats.print_stats(60)
    (out_dir / "cli_host_profile.txt").write_text(buf.getvalue())
    return [
        {"phase": "cli", "n_loci": n_loci, "wall_s": wall_s,
         "loci_per_s": n_loci / wall_s, "device_busy_s": busy,
         "device_busy_share": busy / wall_s, "top_device": _device_table(prof, 8)},
        {"phase": "host", "n_loci": n_loci, "wall_s_under_cprofile": host_wall,
         "top_self_s": _top_self(stats)},
    ]


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/trace_call/report")
    ap.add_argument("--loci", type=int, default=20000)
    args = ap.parse_args(argv)
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
    print(json.dumps(trace_engine(out_dir)), flush=True)
    for line in trace_cli(out_dir, work, args.loci):
        print(json.dumps(line), flush=True)
    for line in trace_preprocess(out_dir, work):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
