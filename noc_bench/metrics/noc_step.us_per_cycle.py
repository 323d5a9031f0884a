"""Device microseconds per simulated cycle of a noc_step launch, the whole
batch together: the launches' device time (CUDA events right around the
library's launch call, every launch of the traced window) over their
cycles."""


def read(run):
    launches = run["launches"]
    if not launches:
        return None
    return 1e6 * (sum(s["device_s"] for s in launches)
                  / sum(s["cycles"] for s in launches))
