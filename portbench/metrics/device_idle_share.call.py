"""device_idle_share.call (%): 1 - the union of the profiler's device
intervals over the traced call window."""


def read(rec):
    if "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
