"""Percent of the profiled slice of the window in which no operation ran
on the device: one less the union of the device's intervals over the
slice's wall time.  Nothing when the profiler saw no device time."""


def read(run):
    prof = run["profile"]
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
