"""engine.launches_per_window (launches): the profiler's device launches in the
traced window (``kernels``, without ``Memcpy`` and ``Memset`` entries) over
the program's ``call.windows`` counter
(``varlociraptor_tpu_torch.tracing``). None where the program counts no
windows (a program without ``tracing``)."""


def read(rec):
    if "window_ns" not in rec or not rec.get("units") or not rec.get("kernels"):
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    windows = s["counters"].get("call.windows")
    if s["dropped"] or not windows:
        return None
    launches = sum(n for name, (_, n) in rec["kernels"].items()
                   if "Memcpy" not in name and "Memset" not in name)
    return launches / windows
