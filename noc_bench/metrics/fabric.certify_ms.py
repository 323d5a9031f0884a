"""Milliseconds per ``fabric.certify`` call, synchronised on exit."""


def read(run):
    calls = run["calls"].get("fabric.certify", 0)
    if not calls:
        return None
    return 1e3 * run["span_s"]["fabric.certify"] / calls
