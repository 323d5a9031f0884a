"""Device operations launched inside the program's ``sim.draw_streams``
span per point it drew (its ``streams.points`` counter), over the
profiled slice's requests: each operation belongs to the spans open at
its launch call (``program_trace.attribute``)."""
from noc_bench import program_trace


def read(run):
    ops = run.get("program_profile", {}).get("device_ops", {})
    points = program_trace.counted(run, "streams.points", "profiled")
    if "sim.draw_streams" not in ops or not points:
        return None
    return ops["sim.draw_streams"] / points
