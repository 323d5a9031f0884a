"""Host milliseconds inside ``sim.batch_operands`` (the random streams and
the stacked operands, synchronised on exit) per simulated point, over the
traced window's ``spans`` requests (``tracing.Probes``)."""


def read(run):
    spent = run["span_s"].get("sim.batch_operands")
    points = sum(r["points"] for r in run["requests"]
                 if r.get("mode") == "spans")
    if spent is None or not points:
        return None
    return 1e3 * spent / points
