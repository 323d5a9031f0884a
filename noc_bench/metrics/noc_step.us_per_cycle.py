"""Device microseconds per simulated cycle of a noc_step launch, the whole
batch together: the launches' device time (CUDA events right around the
library's launch call) over their cycles, over the traced window's
``quiet`` requests.  Those run with the program's telemetry off, so they
time the plain kernel and not its clocked twin."""


def read(run):
    launches = [s for s in run["launches"] if s["mode"] == "quiet"]
    if not launches:
        return None
    return 1e6 * (sum(s["device_s"] for s in launches)
                  / sum(s["cycles"] for s in launches))
