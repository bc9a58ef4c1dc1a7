"""fdr.ms_per_1k_loci (ms): the time of the span ``fdr.control``
(``control_fdr``: parse, threshold and write passes), over the traced
window, per 1,000 loci called (the program's spans,
``varlociraptor_tpu_torch.tracing``). None where the program records no such
span (a program without ``tracing``)."""


def read(rec):
    if "window_ns" not in rec or not rec.get("units"):
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    span = s["spans"].get("fdr.control")
    if s["dropped"] or span is None:
        return None
    return 1e3 * span["total_s"] / (rec["units"] / 1e3)
