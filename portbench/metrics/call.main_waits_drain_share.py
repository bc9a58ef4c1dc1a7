"""call.main_waits_drain_share (%): the time of the span ``call.wait_drain``
over that of ``call.generic``: the share of the call the main thread spent
blocked on the drain thread (its queue full, or the final join), large where
the drain paces the call. None where the program records no such span (a
program without ``varlociraptor_tpu_torch.tracing``)."""


def read(rec):
    if "window_ns" not in rec or not rec.get("units"):
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    wait, root = s["spans"].get("call.wait_drain"), s["spans"].get("call.generic")
    if s["dropped"] or wait is None or root is None or root["total_s"] <= 0.0:
        return None
    return 100.0 * wait["total_s"] / root["total_s"]
