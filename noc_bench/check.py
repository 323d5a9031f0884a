"""The comparison that decides ``correct``: the program's outputs for
``SAMPLE`` of the window's requests, drawn from the seed, against the
plain reference's, leaf by leaf and exactly.

Every accumulator of the simulator is int32 and every float of a report is
worked out from them by the same arithmetic, so the program and the
reference agree bit for bit; the limit of each number is 0.  The numbers:

* ``sim_values_differing``: ``SimResult`` fields (counters, latency,
  throughput, activity, phases, reachability) of every point or leg;
* ``report_values_differing``: the reports' power, area and analytic
  bounds, and a fault scenario's summary;
* ``certificate_values_differing``: the repaired fabric's certificate,
  every property with its counters and witnesses (fault scenarios);
* ``requests_failed``: requests of the window that raised.

A leaf that one side has and the other lacks counts as differing.
"""
from __future__ import annotations

import math

import numpy as np

# Requests of the window, drawn from the seed, that the reference works out
# again: one grid request holds every pattern and rate of its mix.
SAMPLE = 1
LIMITS = {"sim_values_differing": 0, "report_values_differing": 0,
          "certificate_values_differing": 0, "requests_failed": 0}


def leaves(x, path=()):
    """(path, value) of every leaf of nested dicts and lists."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from leaves(x[k], path + (str(k),))
    elif isinstance(x, (list, tuple)):
        yield path + ("len",), len(x)
        for i, v in enumerate(x):
            yield from leaves(v, path + (str(i),))
    else:
        yield path, x


def same(a, b) -> bool:
    """Exact equality (NaN equals NaN; an int equals the equal float)."""
    flags = (bool, np.bool_)
    if isinstance(a, flags) or isinstance(b, flags):
        return isinstance(a, flags) and isinstance(b, flags) and a == b
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def differing(got, want) -> int:
    g, w = dict(leaves(got)), dict(leaves(want))
    return sum(1 for k in g.keys() | w.keys()
               if k not in g or k not in w or not same(g[k], w[k]))


def compare(got: dict, want: dict) -> dict:
    """The three value counts of one request's outputs."""
    n_sim = differing([r["sim"] for r in got.get("reports", [])],
                      [r["sim"] for r in want.get("reports", [])])
    n_rep = differing(
        [{k: v for k, v in r.items() if k != "sim"}
         for r in got.get("reports", [])] + [got.get("summary")],
        [{k: v for k, v in r.items() if k != "sim"}
         for r in want.get("reports", [])] + [want.get("summary")])
    n_cert = differing(got.get("certificate"), want.get("certificate"))
    return {"sim_values_differing": n_sim, "report_values_differing": n_rep,
            "certificate_values_differing": n_cert}


def verdict(counts: dict) -> dict:
    """Each number beside its limit, and whether all hold."""
    numbers = {k: {"value": counts[k], "limit": LIMITS[k]} for k in LIMITS}
    ok = all(v["value"] <= v["limit"] for v in numbers.values())
    return {"correct": ok, "numbers": numbers}
