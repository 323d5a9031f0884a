"""Host milliseconds of re-routing around the dead links (the program's
``topology.reroute_avoiding`` spans) per fault scenario (its
``repair.measure_repair`` spans), over the traced window's ``spans``
requests."""
from noc_bench import program_trace


def read(run):
    scenarios = program_trace.span_ms(run, "repair.measure_repair")
    if not scenarios:
        return None
    spent = program_trace.span_ms(run, "topology.reroute_avoiding")
    return sum(spent) / len(scenarios)
