"""Spans and counters at the call path's layer boundaries, recorded while a
torch profiler runs (``span``, ``traced``, ``count``; ``summary`` reads them).

Tracing is on (``enabled``) exactly while
``torch.autograd.profiler._is_profiler_enabled`` is set, as torch does for
every profiler, a device-only one included; off, ``span`` returns the shared
no-op ``OFF`` and ``count`` returns.  On, each
record is ``(name, thread, start_ns, end_ns, parent, window, n)`` in ``LOG``:
``parent`` is the log index of the enclosing span on the thread (-1: none);
``window`` is the call window's id, given or the enclosing span's (-1: none);
a counter has ``start_ns == end_ns`` and its value in ``n`` (a span: None).
Times are ``time.time_ns()``, the clock of the profiler's host events.  No
profiler range is opened: it would be copied onto the device's timeline.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch.autograd.profiler as _profiler

CAP = 1 << 17  # records a log holds; later ones are dropped and counted
OFF = contextlib.nullcontext()


class Log:
    """A record log of fixed size.  A span's slot is taken when it opens, so
    its children know its index; past the last slot records are dropped,
    and the first and last drop times kept."""

    def __init__(self, cap=CAP):
        self.slots, self.issued, self.drops_ns = [None] * cap, 0, None
        self.lock = threading.Lock()

    def slot(self):
        with self.lock:
            i, self.issued = self.issued, self.issued + 1
            if i >= len(self.slots):
                t = time.time_ns()
                self.drops_ns = ((self.drops_ns or (t,))[0], t)
        return i

    def put(self, i, record):
        if i < len(self.slots):
            self.slots[i] = record

    @property
    def dropped(self):
        return max(0, self.issued - len(self.slots))

    def records(self):
        """(index, record) of every closed span and counter, in slot order."""
        return [(i, r) for i, r in enumerate(self.slots[:self.issued]) if r is not None]


LOG = Log()
_local = threading.local()


def _top():
    """The calling thread's span stack and its innermost (index, window)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack, (stack[-1] if stack else (-1, -1))


class _Span:
    __slots__ = ("name", "window", "i", "parent", "t0", "log")

    def __init__(self, name, window):
        self.name, self.window = name, window

    def __enter__(self):
        stack, (self.parent, outer) = _top()
        self.window = outer if self.window is None else self.window
        self.log = LOG
        self.i = self.log.slot()
        stack.append((self.i, self.window))
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _local.stack.pop()
        self.log.put(self.i, (self.name, threading.current_thread().name, self.t0, t1,
                              self.parent, self.window, None))


def enabled():
    """Whether tracing is on: a torch profiler runs."""
    return getattr(_profiler, "_is_profiler_enabled", False)


def span(name, window=None):
    """A context that records ``name`` from entry to exit while tracing is on."""
    if not enabled():
        return OFF
    return _Span(name, window)


def traced(name):
    """Run the decorated function inside the span ``name``; its locals are
    freed as its frame exits, inside the span."""
    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            with span(name):
                return f(*args, **kwargs)
        return inner
    return wrap


def count(name, n, window=None):
    """Record the counter ``name`` += ``n`` while tracing is on."""
    if not enabled():
        return
    _, (parent, outer) = _top()
    t = time.time_ns()
    LOG.put(LOG.slot(), (name, threading.current_thread().name, t, t, parent,
                         outer if window is None else window, n))


def summary(t0_ns, t1_ns):
    """{"spans": {name: {"total_s", "self_s", "n"}}, "counters": {name: total},
    "dropped": n} of the records that start inside [t0_ns, t1_ns].  Self time
    is a span's duration less its children's; ``dropped`` is the log's drop
    count where its drops overlap the interval, else 0."""
    records = LOG.records()
    inner = {}
    for _, (_, _, s, e, parent, _, n) in records:
        if n is None and parent >= 0:
            inner[parent] = inner.get(parent, 0) + e - s
    spans, counters = {}, {}
    for i, (name, _, s, e, _, _, n) in records:
        if not t0_ns <= s <= t1_ns:
            continue
        if n is not None:
            counters[name] = counters.get(name, 0) + n
            continue
        total, own, k = spans.get(name, (0, 0, 0))
        spans[name] = (total + e - s, own + e - s - inner.get(i, 0), k + 1)
    drops = LOG.drops_ns
    return {"spans": {k: {"total_s": t / 1e9, "self_s": o / 1e9, "n": n}
                      for k, (t, o, n) in spans.items()},
            "counters": counters,
            "dropped": LOG.dropped if drops and drops[0] <= t1_ns and drops[1] >= t0_ns else 0}
