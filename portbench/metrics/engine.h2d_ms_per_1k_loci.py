"""engine.h2d_ms_per_1k_loci (ms): the profiler's device milliseconds of
host-to-device copies over the window, per 1,000 loci called."""

from portbench.lib.trace import kernel_seconds


def read(rec):
    secs, n = kernel_seconds(rec.get("kernels", {}), "Memcpy HtoD")
    if n == 0 or rec.get("units", 0) == 0:
        return None
    return 1e3 * secs / (rec["units"] / 1e3)
