"""The traced run's record: the profiler's device intervals and the
harness's host spans, reduced to what the per-layer metrics read.

The union of device intervals and the table by kernel name follow
``varlociraptor_tpu_torch/trace_call.py`` (``_device_events``,
``_device_busy_s``, ``_device_table``, commit 8830722), read from the
profiler's raw Kineto events, which stay fast at the ~10^5 events of a
window.  Host spans are ``torch.profiler.record_function`` ranges whose
names start with ``SPAN``; they name what the host was doing while the
device sat idle.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

SPAN = "pb."
WINDOW = SPAN + "window"
TOP = 10  # entries of each breakdown list


@contextlib.contextmanager
def span(name):
    """A host span ``SPAN + name``: a profiler range, no-op untraced."""
    import torch

    with torch.profiler.record_function(SPAN + name):
        yield


def _fields(e):
    """(name, on the device, start ns, end ns) of a Kineto or FunctionEvent."""
    from torch.autograd import DeviceType

    name = e.name() if callable(e.name) else e.name
    dev = e.device_type() if callable(e.device_type) else e.device_type
    if hasattr(e, "start_ns"):
        s, d = e.start_ns(), e.duration_ns()
    elif hasattr(e, "start_us") and callable(e.start_us):
        s, d = e.start_us() * 1000, e.duration_us() * 1000
    else:
        s, d = e.time_range.start * 1000, e.time_range.elapsed_us() * 1000
    return name, dev == DeviceType.CUDA, s, s + d


def _events(prof):
    try:
        return prof.profiler.kineto_results.events()
    except AttributeError:
        return prof.events()


def reduce(prof):
    """:func:`reduce_events` of a finished ``torch.profiler.profile``."""
    return reduce_events(_events(prof))


def reduce_events(events):
    """{"window_ns", "busy_s", "kernels": {name: [seconds, launches]},
    "device_ops", "idle_gaps"} of profiler events whose window is the
    ``WINDOW`` span; device intervals are cut to the window."""
    device, spans, window = [], [], None
    for e in events:
        name, on_device, s, t = _fields(e)
        if on_device:
            # the profiler copies each host range onto the device's timeline
            # as an annotation: no device work
            if not name.startswith(SPAN) and name != "Activity Buffer Request" and t > s:
                device.append((s, t, name))
        elif name == WINDOW:
            window = (s, t)
        elif name.startswith(SPAN):
            spans.append((s, t, name[len(SPAN):]))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    kernels = defaultdict(lambda: [0.0, 0])
    cut = []
    for s, t, name in device:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        cut.append((s, t))
        kernels[name][0] += (t - s) / 1e9
        kernels[name][1] += 1
    merged = _union(cut)
    busy = sum(t - s for s, t in merged)
    gaps, prev = [], w0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = _idle_by_span(gaps, sorted(spans))
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "window_ns": (w0, w1),
        "busy_s": busy / 1e9,
        "kernels": {k: v for k, v in kernels.items()},
        "device_ops": [[k[:120], v[0]] for k, v in ops[:TOP]],
        "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def _union(intervals):
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def device_busy_s(prof):
    """Seconds in which an operation ran on the device over the whole of a
    finished profile (one recording device activity alone, started at the
    window's start and stopped at its end): the union of its device
    intervals."""
    cut = []
    for e in _events(prof):
        name, on_device, s, t = _fields(e)
        if on_device and not name.startswith(SPAN) and name != "Activity Buffer Request" \
                and t > s:
            cut.append((s, t))
    return sum(t - s for s, t in _union(cut)) / 1e9


def _idle_by_span(gaps, spans):
    """{host span: idle device seconds}: each gap (in time order) cut at the
    span boundaries inside it, every piece given to the innermost span (the
    last to start) that covers it, "harness" where none does."""
    idle = defaultdict(float)
    active, k = [], 0
    for a, b in gaps:
        while k < len(spans) and spans[k][0] < b:
            active.append(spans[k])
            k += 1
        active = [x for x in active if x[1] > a]
        cuts = sorted({a, b, *(p for s, t, _ in active for p in (s, t) if a < p < b)})
        for p, q in zip(cuts, cuts[1:]):
            mid, host = (p + q) / 2, "harness"
            for s, t, name in active:
                if s <= mid <= t:
                    host = name
            idle[host] += (q - p) / 1e9
    return idle


def kernel_seconds(kernels, *needles):
    """Device seconds and launches of the kernels whose name holds one of
    ``needles``."""
    secs = n = 0
    for name, (s, k) in kernels.items():
        if any(x in name for x in needles):
            secs += s
            n += k
    return secs, n
