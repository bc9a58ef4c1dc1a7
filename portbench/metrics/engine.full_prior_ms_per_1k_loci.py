"""engine.full_prior_ms_per_1k_loci (ms): the program's
``engine.full_prior_stream_ns`` counter (the stream time of the engine's
--full-prior passes, between a CUDA event at the start of each and one at
its end) in the traced window, per 1,000 loci called
(``varlociraptor_tpu_torch.tracing``). None where the program has no such
counter (a program without it, or a call without --full-prior)."""


def read(rec):
    if "window_ns" not in rec or not rec.get("units"):
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    ns = s["counters"].get("engine.full_prior_stream_ns")
    if s["dropped"] or not ns:
        return None
    return 1e3 * (ns / 1e9) / (rec["units"] / 1e3)
