"""The noc_step kernel's share of its roofline: the least time of each
launch (``roofline.kernel_bound_s``, from shapes only) over the launches'
device time (CUDA events right around the library's launch call), over
the traced window's ``quiet`` requests, which run the plain kernel (the
program's telemetry off)."""
from noc_bench import roofline


def read(run):
    launches = [s for s in run["launches"] if s["mode"] == "quiet"]
    if not launches:
        return None
    return 100.0 * (sum(roofline.kernel_bound_s(s) for s in launches)
                    / sum(s["device_s"] for s in launches))
