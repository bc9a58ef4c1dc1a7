"""lfc.roofline_share (%): the frozen bound of the l2fc integrals' work
(``roofline_lfc.lfc_roofline`` of the program's ``engine.lfc_cells`` and
``engine.lfc_bytes`` counters) over their stream time
(``engine.lfc_stream_ns``), in the traced window
(``varlociraptor_tpu_torch.tracing``). The stream time holds at least the
passes' device time, so the share cannot pass 100% unless the work is
counted too high. None where the program has no such counters."""

from portbench.lib.roofline_lfc import lfc_roofline


def read(rec):
    if "window_ns" not in rec:
        return None
    try:
        from varlociraptor_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary(*rec["window_ns"])
    c = s["counters"]
    ns, cells = c.get("engine.lfc_stream_ns"), c.get("engine.lfc_cells")
    if s["dropped"] or not ns or not cells or "engine.lfc_bytes" not in c:
        return None
    return 100.0 * lfc_roofline(cells, c["engine.lfc_bytes"])["bound_s"] / (ns / 1e9)
