"""The noc_step kernel's share of its roofline: the least time of every
launch of the traced window (``roofline.kernel_bound_s``, from shapes
only) over the launches' device time (CUDA events right around the
library's launch call)."""
from noc_bench import roofline


def read(run):
    launches = run["launches"]
    if not launches:
        return None
    return 100.0 * (sum(roofline.kernel_bound_s(s) for s in launches)
                    / sum(s["device_s"] for s in launches))
