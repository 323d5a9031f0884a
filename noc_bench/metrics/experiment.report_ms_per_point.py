"""Host milliseconds per point of the report's assembly (the program's
``experiment.report`` span, one a point: power, area and the analytic
bounds), over the traced window's ``spans`` requests."""
from noc_bench import program_trace


def read(run):
    spent = program_trace.span_ms(run, "experiment.report")
    return sum(spent) / len(spent) if spent else None
