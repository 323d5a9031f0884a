"""The 90th percentile (nearest rank) of the latency of all the window's
requests, from building the experiments to the reports on the host: the
highest percentile with ten requests beyond it at the window's ~150-180
grid requests."""
import math


def read(run):
    lat = sorted(r["latency_s"] for r in run["requests"])
    if not lat:
        return None
    return lat[math.ceil(0.90 * len(lat)) - 1]
