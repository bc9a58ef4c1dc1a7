"""call.loci_per_s_wall (loci/s): loci through ``call_generic`` and then
``control_fdr`` over the traced window's wall seconds: the host's pace,
read under the profiler."""


def read(rec):
    if not rec.get("units"):
        return None
    return rec["units"] / rec["window_s"]
