"""Host milliseconds per ``sim.build_geometry`` call (the program's span:
the route table's upload, and on a new fabric its structural tables), one
a batch, over the traced window's ``spans`` requests."""
from noc_bench import program_trace


def read(run):
    spent = program_trace.span_ms(run, "sim.build_geometry")
    return sum(spent) / len(spent) if spent else None
