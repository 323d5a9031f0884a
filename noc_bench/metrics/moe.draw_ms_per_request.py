"""Milliseconds a request of the hidden states' draw on the card (the
program's ``moe.draw`` span inside ``moe.route``: iid grid values, or each
token's topic and its noise; the span closes after a device synchronise,
so it holds the draw's device time), over the traced window's ``spans``
requests: one span a request."""
from noc_bench import program_trace


def read(run):
    spent = program_trace.span_ms(run, "moe.draw")
    return sum(spent) / len(spent) if spent else None
