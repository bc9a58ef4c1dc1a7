"""engine.h2d_bytes_per_locus (bytes): the program's ``engine.h2d_bytes``
counter (input bytes the engine copies to its device) over its ``call.loci``
counter, in the traced window (``varlociraptor_tpu_torch.tracing``). None
where the program has no such counters (a program without ``tracing``)."""


def read(rec):
    if "window_ns" not in rec or not rec.get("units"):
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    loci = s["counters"].get("call.loci")
    if s["dropped"] or not loci or "engine.h2d_bytes" not in s["counters"]:
        return None
    return s["counters"]["engine.h2d_bytes"] / loci
