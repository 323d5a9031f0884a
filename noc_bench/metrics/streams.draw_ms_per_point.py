"""Host milliseconds inside the program's ``sim.draw_streams`` span (the
random streams of a batch, unsynchronised) per point it drew (its
``streams.points`` counter), over the traced window's ``spans``
requests."""
from noc_bench import program_trace


def read(run):
    spent = program_trace.span_ms(run, "sim.draw_streams")
    points = program_trace.counted(run, "streams.points", "spans")
    if not spent or not points:
        return None
    return sum(spent) / points
