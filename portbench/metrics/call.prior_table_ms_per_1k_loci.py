"""call.prior_table_ms_per_1k_loci (ms): the total time of the span
``call.prior_table`` (the host's --full-prior joint prior tables, built once
a call per prior key) over the traced window, per 1,000 loci called (the
program's spans, ``varlociraptor_tpu_torch.tracing``). None where the
program records no such span (a program without it, or a call without
--full-prior)."""


def read(rec):
    if "window_ns" not in rec or not rec.get("units"):
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    span = s["spans"].get("call.prior_table")
    if s["dropped"] or span is None:
        return None
    return 1e3 * span["total_s"] / (rec["units"] / 1e3)
