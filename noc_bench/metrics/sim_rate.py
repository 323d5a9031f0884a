"""Simulated PE-cycles per second of host time: the budget's cycles (warm-up
included) times the PEs of every point the window completed, over the
window's whole elapsed time."""


def read(run):
    return sum(r["work"] for r in run["requests"]) / run["elapsed_s"]
