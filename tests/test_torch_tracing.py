"""The port's spans and counters (``varlociraptor_tpu_torch.tracing``).

* with no profiler running, a span and a counter record nothing;
* under a CPU-only ``torch.profiler``, one columnar ``call_generic`` of
  three windows and its ``control_fdr`` record every span of the call path
  on the right thread, under the right parent and with the right window
  id, and the window and locus counters match what was written;
* ``summary``'s totals and self times on a log made by hand;
* a span and a ``record_function`` range start together on the profiler's
  clock, and the profile holds no name of a program span.
"""

import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from varlociraptor_tpu_torch import tracing
from varlociraptor_tpu_torch.bench_utils import synth_observation_files
from varlociraptor_tpu_torch.calling.call import CallOptions, call_generic
from varlociraptor_tpu_torch.filtration.fdr import control_fdr
from varlociraptor_tpu_torch.grammar.scenario import tumor_normal_scenario

N_LOCI, WINDOW = 150, 64  # windows of 64, 64 and 22 loci
N_WINDOWS = 3
MAIN, DRAIN = "MainThread", "vlt-drain"

# span: (thread, parent span, the window ids it carries)
PER_WINDOW = set(range(N_WINDOWS))
SPANS = {
    "call.generic": (MAIN, None, {-1}),
    "call.read": (MAIN, "call.generic", PER_WINDOW | {N_WINDOWS}),  # and the last, empty read
    "call.pack": (MAIN, "call.generic", PER_WINDOW),
    "engine.dispatch": (MAIN, "call.pack", PER_WINDOW),
    "engine.assemble": (MAIN, "engine.dispatch", PER_WINDOW),
    "call.wait_drain": (MAIN, "call.generic", PER_WINDOW | {-1}),  # and the final join
    "call.drain": (DRAIN, None, {-1}),
    "call.wait_main": (DRAIN, "call.drain", PER_WINDOW | {N_WINDOWS}),  # and the end mark
    "engine.fetch": (DRAIN, "call.drain", PER_WINDOW),
    "call.format": (DRAIN, "call.drain", PER_WINDOW),
    "fdr.control": (MAIN, None, {-1}),
}


@pytest.fixture
def fresh_log(monkeypatch):
    log = tracing.Log()
    monkeypatch.setattr(tracing, "LOG", log)
    return log


def test_off_records_nothing(fresh_log):
    assert tracing.span("call.read", 0) is tracing.OFF
    with tracing.span("call.read", 0):
        tracing.count("call.loci", 5, 0)
    assert fresh_log.issued == 0 and fresh_log.records() == []


@pytest.fixture(scope="module")
def traced_call(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    tumor, normal, _ = synth_observation_files(d, n_loci=N_LOCI, seed=0)
    saved = tracing.LOG
    tracing.LOG = log = tracing.Log()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.time_ns()
            n = call_generic(
                tumor_normal_scenario(0.75), {"tumor": tumor, "normal": normal},
                str(d / "calls.vcf"), CallOptions(batch_size=WINDOW), device="cpu",
            )
            control_fdr(str(d / "calls.vcf"), str(d / "fdr.vcf"),
                        events=["somatic_tumor"], alpha=0.05)
            t1 = time.time_ns()
    finally:
        tracing.LOG = saved
    written = sum(1 for line in (d / "calls.vcf").read_text().splitlines()
                  if not line.startswith("#"))
    return {"log": log, "n": n, "written": written, "prof": prof, "window": (t0, t1)}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_call_path_span(traced_call, name):
    thread, parent, windows = SPANS[name]
    records = dict(traced_call["log"].records())
    mine = [r for r in records.values() if r[0] == name and r[6] is None]
    assert mine, f"no {name} span"
    for _, th, s, e, p, _, _ in mine:
        assert th == thread and s <= e
        if parent is None:
            assert p == -1
        else:
            outer = records[p]
            assert outer[0] == parent and outer[1] == thread
            assert outer[2] <= s and e <= outer[3]
    assert {r[5] for r in mine} == windows
    if name == "engine.dispatch":
        # a span given no window carries its parent's
        assert all(records[r[4]][5] == r[5] for r in mine)


def test_call_path_counters(traced_call, monkeypatch):
    log = traced_call["log"]
    counters = {}
    for _, (name, th, s, e, _, window, n) in log.records():
        if n is not None:
            # the stream times are read where the fetch completes
            assert s == e and th == (DRAIN if name.endswith("_stream_ns") else MAIN)
            counters.setdefault(name, []).append((window, n))
    assert counters["call.windows"] == [(w, 1) for w in range(N_WINDOWS)]
    assert sum(n for _, n in counters["call.loci"]) == traced_call["n"] == traced_call["written"]
    assert [n for _, n in counters["call.loci"]] == [64, 64, 22]
    assert sum(n for _, n in counters["engine.dispatches"]) >= N_WINDOWS
    assert all(n > 0 for _, n in counters["engine.h2d_bytes"])
    # one assemble pass a window, its kernels on the card only
    assert len(counters["engine.assemble_stream_ns"]) == N_WINDOWS
    assert all(n > 0 for _, n in counters["engine.assemble_stream_ns"])
    assert "engine.assemble_launches" not in counters
    assert log.dropped == 0
    monkeypatch.setattr(tracing, "LOG", log)
    summary = tracing.summary(*traced_call["window"])
    assert summary["counters"]["call.windows"] == N_WINDOWS
    assert summary["counters"]["call.loci"] == N_LOCI
    assert summary["spans"]["call.generic"]["n"] == 1


def test_profile_holds_no_program_span(traced_call):
    names = {e.name for e in traced_call["prof"].events()}
    assert names and not names & set(SPANS)
    assert not any(n.startswith(("call.", "engine.", "fdr.")) for n in names)


def test_summary_of_a_handmade_log(fresh_log):
    recs = [
        ("call.generic", MAIN, 1_000, 11_000, -1, -1, None),   # 0
        ("call.read", MAIN, 2_000, 3_000, 0, 0, None),          # 1
        ("call.pack", MAIN, 3_000, 7_000, 0, 0, None),          # 2
        ("engine.dispatch", MAIN, 4_000, 6_500, 2, 0, None),    # 3
        ("call.windows", MAIN, 7_000, 7_000, 0, 0, 1),          # 4
        ("call.loci", MAIN, 7_000, 7_000, 0, 0, 1024),          # 5
        ("call.read", MAIN, 8_000, 8_500, 0, 1, None),          # 6
        ("call.read", MAIN, 20_000, 21_000, -1, 2, None),       # 7: outside
    ]
    for r in recs:
        fresh_log.put(fresh_log.slot(), r)
    s = tracing.summary(1_000, 11_000)
    assert s["dropped"] == 0
    assert s["counters"] == {"call.windows": 1, "call.loci": 1024}
    assert s["spans"] == {
        "call.generic": {"total_s": 10_000 / 1e9, "self_s": 4_500 / 1e9, "n": 1},
        "call.read": {"total_s": 1_500 / 1e9, "self_s": 1_500 / 1e9, "n": 2},
        "call.pack": {"total_s": 4_000 / 1e9, "self_s": 1_500 / 1e9, "n": 1},
        "engine.dispatch": {"total_s": 2_500 / 1e9, "self_s": 2_500 / 1e9, "n": 1},
    }
    assert tracing.summary(20_000, 30_000)["spans"]["call.read"]["n"] == 1


def test_full_log_counts_what_it_drops(monkeypatch):
    log = tracing.Log(cap=2)
    monkeypatch.setattr(tracing, "LOG", log)
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("call.windows", 1)
        t_full = time.time_ns()
        for _ in range(2):
            tracing.count("call.windows", 1)
        with tracing.span("call.read"):
            pass
    assert log.dropped == 2 and len(log.records()) == 2
    assert tracing.summary(0, 2**63)["dropped"] == 2
    # a window that closed before the log filled is whole
    assert tracing.summary(0, t_full)["dropped"] == 0
    assert tracing.summary(0, t_full)["counters"] == {"call.windows": 1}


def test_off_without_the_profiler_flag(fresh_log, monkeypatch):
    # a torch without the flag leaves tracing off rather than failing the call
    monkeypatch.setattr(tracing, "_profiler", types.SimpleNamespace())
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("call.read", 0) is tracing.OFF
        tracing.count("call.loci", 5, 0)
    assert fresh_log.issued == 0


def test_traced_function_runs_in_its_span(fresh_log):
    @tracing.traced("call.generic")
    def f(x):
        """doc"""
        with tracing.span("call.read"):
            return x + 1

    assert f(1) == 2 and f.__doc__ == "doc" and fresh_log.issued == 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(2) == 3
    (i, outer), (_, inner_rec) = fresh_log.records()
    assert outer[0] == "call.generic" and outer[4] == -1
    assert inner_rec[0] == "call.read" and inner_rec[4] == i


def test_counter_takes_the_enclosing_span(fresh_log):
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("call.windows", 1)
        with tracing.span("call.pack", 4):
            tracing.count("engine.h2d_bytes", 96)
            tracing.count("call.loci", 7, 5)
    (_, root), (i, _), (_, inner), (_, given) = fresh_log.records()
    assert root[4:] == (-1, -1, 1)
    assert inner[4:] == (i, 4, 96)  # parent and window of call.pack
    assert given[4:] == (i, 5, 7)


def test_span_and_profiler_range_share_a_clock(fresh_log):
    # five probes: a clock offset shows in each, a preemption in a few
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe.first"):  # the profiler's own first-range set-up
            pass
        for i in range(5):
            with record_function(f"probe.{i}"):
                with tracing.span(f"probe.{i}"):
                    time.sleep(0.01)
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()}
    offsets = [abs(rec[2] - starts[rec[0]]) for _, rec in fresh_log.records()]
    assert len(offsets) == 5 and min(offsets) < 200_000


# tumor and relapse contaminated by one normal, events split by l2fc(relapse,
# tumor): the star route of PosteriorEngine._lfc_group_term, at resolution 0.1
LFC_SCENARIO = {
    "samples": {
        "normal": {"resolution": 0.1, "universe": "[0.0,0.5[ | 0.5 | 1.0"},
        "tumor": {"resolution": 0.1, "universe": "[0.0,1.0]",
                  "contamination": {"by": "normal", "fraction": 0.25}},
        "relapse": {"resolution": 0.1, "universe": "[0.0,1.0]",
                    "contamination": {"by": "normal", "fraction": 0.4}},
    },
    "events": {
        "germline_het": "normal:0.5",
        "stable": "normal:0.0 & tumor:]0.0,1.0] & relapse:]0.0,1.0] "
                  "& l2fc(relapse, tumor) >= -1 & l2fc(relapse, tumor) <= 1",
        "expanded": "normal:0.0 & tumor:]0.0,1.0] & relapse:]0.0,1.0] "
                    "& l2fc(relapse, tumor) > 1",
    },
}
LFC_COUNTERS = ("engine.lfc_steps", "engine.lfc_cells", "engine.lfc_bytes",
                "engine.lfc_stream_ns")


def _lfc_window(traced):
    from varlociraptor_tpu_torch.bench_utils import engine_inputs, scenario_engine

    _, engine = scenario_engine(LFC_SCENARIO, 0.1, device="cpu")
    args = engine_inputs(engine, n_loci=8, depth=4, seed=1)
    log = tracing.Log()
    saved, tracing.LOG = tracing.LOG, log
    try:
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                engine.run(*args)
        else:
            engine.run(*args)
    finally:
        tracing.LOG = saved
    return engine, args, log


def test_lfc_pass_records_its_span_and_counters():
    engine, args, log = _lfc_window(traced=True)
    records = [r for _, r in log.records()]
    spans = [r for r in records if r[0] == "engine.lfc" and r[6] is None]
    counters = {r[0]: r[6] for r in records if r[0] in LFC_COUNTERS}
    assert len(spans) == 1 and set(counters) == set(LFC_COUNTERS)
    tumor, relapse, normal = (engine.values_s[i].size for i in (1, 2, 0))
    L, B = args[0].shape[0], args[2].shape[2]
    branches = len(engine._lfc_t)  # the two l2fc events and their artifact twins
    assert branches == 4 and not engine._stream_marks
    # one star integral a branch: every (tumor, relapse, normal) grid cell
    assert counters["engine.lfc_cells"] == branches * L * B * tumor * relapse * normal
    assert counters["engine.lfc_steps"] == branches * normal
    # fa, fb, rp and the mask read once, the two [L, B] outputs written once
    assert counters["engine.lfc_bytes"] == branches * 4 * (
        L * B * normal * (tumor + relapse + 1) + tumor * relapse + 2 * L * B)
    assert 0 < counters["engine.lfc_stream_ns"] <= spans[0][3] - spans[0][2]


def test_lfc_pass_records_nothing_untraced():
    engine, _, log = _lfc_window(traced=False)
    assert log.issued == 0 and not engine._stream_marks and engine.loop_steps > 0
