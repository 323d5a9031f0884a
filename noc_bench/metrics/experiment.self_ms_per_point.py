"""Self time of ``run_experiments`` per point: its wall time less that of
its wrapped children (topology builds, geometry, streams, the kernel,
reachability), which leaves grouping, results and report assembly; over
the traced window's ``spans`` requests (``tracing.Probes``)."""

NAME = "experiment.run_experiments"


def read(run):
    points = sum(r["points"] for r in run["requests"]
                 if r.get("mode") == "spans")
    if NAME not in run["span_s"] or not points:
        return None
    own = run["span_s"][NAME] - run["child_s"].get(NAME, 0.0)
    return 1e3 * own / points
