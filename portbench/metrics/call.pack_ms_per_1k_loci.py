"""call.pack_ms_per_1k_loci (ms): the self time of the span ``call.pack``
(``call_window_cb``'s host model work and packing, less the engine's
dispatch; main thread), over the traced window, per 1,000 loci called (the
program's spans, ``varlociraptor_tpu_torch.tracing``). None where the
program records no such span (a program without ``tracing``)."""


def read(rec):
    if "window_ns" not in rec or not rec.get("units"):
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    span = s["spans"].get("call.pack")
    if s["dropped"] or span is None:
        return None
    return 1e3 * span["self_s"] / (rec["units"] / 1e3)
