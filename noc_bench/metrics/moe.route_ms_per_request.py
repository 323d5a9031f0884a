"""Milliseconds a request of the router on the card (the program's
``moe.route`` span: the hidden states and the layer's router drawn, the
float32 GEMM and the group-limited top-k; the span closes after a device
synchronise, so it holds their device time), over the traced window's
``spans`` requests: one span a request."""
from noc_bench import program_trace


def read(run):
    spent = program_trace.span_ms(run, "moe.route")
    return sum(spent) / len(spent) if spent else None
