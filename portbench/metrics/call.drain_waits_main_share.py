"""call.drain_waits_main_share (%): the time of the span ``call.wait_main``
over that of ``call.drain``: the share of the drain thread's life spent
waiting for the main thread's next window, large where the main thread paces
the call. None where the program records no such span (a program without
``varlociraptor_tpu_torch.tracing``)."""


def read(rec):
    if "window_ns" not in rec or not rec.get("units"):
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    wait, root = s["spans"].get("call.wait_main"), s["spans"].get("call.drain")
    if s["dropped"] or wait is None or root is None or root["total_s"] <= 0.0:
        return None
    return 100.0 * wait["total_s"] / root["total_s"]
