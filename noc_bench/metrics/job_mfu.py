"""The whole request's share of the chip's peak: the least time of its
device work (each launch's roofline bound plus writing its streams once,
``roofline.job_bound_s``) over the requests' wall time.  Only the traced
window's ``quiet`` requests count, which nothing synchronises or
profiles, so their wall time is an untraced request's."""
from noc_bench import roofline


def read(run):
    quiet = {r["index"]: r["latency_s"] for r in run["requests"]
             if r.get("mode") == "quiet" and r["ok"]}
    launches = [s for s in run["launches"] if s.get("request") in quiet]
    wall = sum(quiet.values())
    if not launches or wall <= 0:
        return None
    return 100.0 * sum(roofline.job_bound_s(s) for s in launches) / wall
