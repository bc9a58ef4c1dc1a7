"""full_prior.roofline_share (%): the frozen bound of the --full-prior
passes' work (``roofline_full_prior.full_prior_roofline`` of the program's
``engine.full_prior_cells`` and ``engine.full_prior_bytes`` counters) over
their stream time (``engine.full_prior_stream_ns``), in the traced window
(``varlociraptor_tpu_torch.tracing``). The stream time holds at least the
passes' device time, so the share cannot pass 100% unless the work is
counted too high. None where the program has no such counters."""

from portbench.lib.roofline_full_prior import full_prior_roofline


def read(rec):
    if "window_ns" not in rec:
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    c = s["counters"]
    ns, cells = c.get("engine.full_prior_stream_ns"), c.get("engine.full_prior_cells")
    if s["dropped"] or not ns or not cells or "engine.full_prior_bytes" not in c:
        return None
    return 100.0 * full_prior_roofline(cells, c["engine.full_prior_bytes"])["bound_s"] / (ns / 1e9)
