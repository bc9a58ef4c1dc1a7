"""k1.roofline_share (%): the frozen roofline of every K1 launch (shapes
(N, U, D) from ``ll_classes.launch_hook``) over the profiler's device
seconds of ``ll_classes_kernel``."""

from portbench.lib.roofline import k1_roofline
from portbench.lib.trace import kernel_seconds


def read(rec):
    launches = rec.get("k1_launches", ())
    secs, _ = kernel_seconds(rec.get("kernels", {}), "ll_classes_kernel")
    if not launches or secs <= 0.0:
        return None
    return 100.0 * sum(k1_roofline(*x)["bound_s"] for x in launches) / secs
