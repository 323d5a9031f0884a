"""Host milliseconds a request of the trace front end (the program's
``trace.build`` span: a collective schedule's census decomposed into a
``TraceSpec``, or a layer's routing laid out as a ``TraceRecords``), over
the traced window's ``spans`` requests: one span a request."""
from noc_bench import program_trace


def read(run):
    spent = program_trace.span_ms(run, "trace.build")
    return sum(spent) / len(spent) if spent else None
