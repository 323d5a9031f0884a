"""The program's own telemetry (``repro_torch.telemetry``) in a traced run:
its spans, counters and kernel records, tagged by request, and the
profiled slice's device operations and idle gaps attributed to the
program's spans.

``harness.run`` makes an ``Adapter`` for a traced run.  It turns telemetry
on for the window's ``spans`` and ``profiled`` requests only (so ``quiet``
requests, which ``job_mfu`` and the kernel's time a cycle read, and every
untraced run stay as they are) and drains it after each request.
``read(prof)`` gives the run record's keys:

* ``program_spans``: each span (name, id, parent, request, start and end
  in ns on the profiler's clock) with its request's ``mode``;
* ``program_counters``: each request's counters, with its index and mode;
* ``program_kernels``: each kernel record (``noc_step.passes`` of both
  backends, ``noc_step.clock`` of the CUDA kernel) with its mode;
* ``program_profile``: over the profiled slice, ``device_ops`` (the
  device operations launched inside each span name, children included),
  ``idle_gaps`` (idle seconds by the innermost program span open in the
  gap, ``harness`` outside them all) and ``unattributed`` (operations
  whose launch call the trace did not hold).

A metric reader (``metrics/<name>.py``) takes a span or a counter from
these keys by name: ``span_seconds`` (self and total seconds of a span
name), ``span_ms`` (each span's milliseconds) and ``counted`` (a
counter's total).

Run as a tool, it runs one cell traced, as the benchmark does, prints the
result line, and on standard error the split the telemetry shows: for
the ``spans`` requests, each span's self time a request and the
counters; for the slice, its idle seconds and device operations by
program span::

    python3 noc_bench/program_trace.py --workload ring_mesh-1024.paper_grid \\
        --seed 7 --seconds 51
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

TRACED = ("spans", "profiled")


def _telemetry():
    """The program's telemetry module, or None where the program has
    none."""
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    return telemetry


class Adapter:
    def __init__(self):
        self.tm = _telemetry()
        self.spans, self.counters, self.kernels = [], [], []
        self.profile = {}
        self._current = None

    def begin(self, i: int, mode: str) -> None:
        """Before request ``i``: telemetry on for a traced mode."""
        self._current = None
        if self.tm is None or mode not in TRACED:
            return
        self.tm.drain()          # what quiet requests counted
        self.tm.request(i)
        self.tm.enable()
        self._current = (i, mode)

    def end(self) -> None:
        """After the request, the device synchronised: drain it."""
        if self._current is None:
            return
        i, mode = self._current
        self._current = None
        self.tm.disable()
        self.tm.request(None)
        out = self.tm.drain()
        self.spans += [dict(s, mode=mode) for s in out["spans"]]
        self.counters.append(dict(request=i, mode=mode,
                                  counters=out["counters"]))
        self.kernels += [dict(k, mode=mode) for k in out["kernels"]]

    def read(self, prof=None) -> dict:
        """The record's new keys; ``prof`` is the slice's profiler."""
        if prof is not None:
            profiled = [s for s in self.spans if s["mode"] == "profiled"]
            self.profile = attribute(
                list(prof.profiler.kineto_results.events()), profiled)
        return dict(program_spans=self.spans,
                    program_counters=self.counters,
                    program_kernels=self.kernels,
                    program_profile=self.profile)


# -- reading the keys (the metric readers' helpers) ---------------------------
def span_ms(run: dict, name: str, mode: str = "spans") -> list[float]:
    """Milliseconds of each span ``name`` of the ``mode`` requests."""
    return [(s["end_ns"] - s["start_ns"]) / 1e6
            for s in run.get("program_spans", ())
            if s["name"] == name and s["mode"] == mode]


def span_seconds(run: dict, name: str,
                 mode: str = "spans") -> tuple[float, float] | None:
    """Self and total seconds of the spans ``name`` of the ``mode``
    requests (self: less their direct children), or None where there is
    none."""
    spans = [s for s in run.get("program_spans", ()) if s["mode"] == mode]
    ids = {s["id"] for s in spans if s["name"] == name}
    if not ids:
        return None
    total = sum(s["end_ns"] - s["start_ns"] for s in spans
                if s["id"] in ids)
    children = sum(s["end_ns"] - s["start_ns"] for s in spans
                   if s["parent"] in ids)
    return (total - children) / 1e9, total / 1e9


def counted(run: dict, name: str, mode: str = "spans") -> int:
    """The counter ``name`` summed over the ``mode`` requests."""
    return sum(c["counters"].get(name, 0)
               for c in run.get("program_counters", ())
               if c["mode"] == mode)


# -- the profiled slice -------------------------------------------------------
def _innermost(spans: list[dict]):
    """Segments of the host timeline, each with the id of the innermost
    span open in it (None outside all): (sorted starts, ids).  Spans of
    one thread nest."""
    starts, ids, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            starts.append(end)
            ids.append(stack[-1][1] if stack else None)

    for s in sorted(spans, key=lambda x: (x["start_ns"], -x["end_ns"])):
        close_until(s["start_ns"])
        stack.append((s["end_ns"], s["id"]))
        starts.append(s["start_ns"])
        ids.append(s["id"])
    close_until(float("inf"))
    return starts, ids


def attribute(events: list, spans: list[dict]) -> dict:
    """Device operations and idle gaps of a profile (kineto's events) by
    program span.  An operation belongs to the spans open at its launch
    call (the host event with its correlation id); an idle gap to the
    innermost span open at its middle.  Only the ``harness.slice`` event's
    interval counts, where the profile has one."""
    import torch

    from noc_bench import tracing
    dev_type = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name() == "harness.slice"]
    w0 = window[0].start_ns() if window else float("-inf")
    w1 = (w0 + window[0].duration_ns()) if window else float("inf")
    ops = [e for e in events if e.device_type() == dev_type
           and not tracing._annotation(e)
           and e.start_ns() < w1 and e.start_ns() + e.duration_ns() > w0]
    if not ops or not spans:
        return {}
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != dev_type and e.name().startswith("cu")}
    by_id = {s["id"]: s for s in spans}
    starts, ids = _innermost(spans)

    def open_at(t):
        at = bisect.bisect_right(starts, t) - 1
        return ids[at] if at >= 0 else None

    device_ops = collections.Counter()
    unattributed = 0
    for e in ops:
        t = launch.get(e.correlation_id())
        if t is None:
            unattributed += 1
            continue
        names, sid = set(), open_at(t)
        while sid is not None:
            names.add(by_id[sid]["name"])
            sid = by_id[sid]["parent"]
        device_ops.update(names)
    busy = tracing._merge([(max(e.start_ns(), w0),
                            min(e.start_ns() + e.duration_ns(), w1))
                           for e in ops])
    gaps = collections.Counter()
    cursor = busy[0][0] if w0 == float("-inf") else w0
    end = busy[-1][1] if w1 == float("inf") else w1
    for s, e in busy + [[end, end]]:
        if s > cursor:
            sid = open_at((cursor + s) / 2)
            name = by_id[sid]["name"] if sid is not None else "harness"
            gaps[name] += (s - cursor) / 1e9
        cursor = max(cursor, e)
    return {"device_ops": dict(device_ops), "unattributed": unattributed,
            "idle_gaps": [[n, v] for n, v in gaps.most_common()]}


# -- the tool -----------------------------------------------------------------
def run(workload: str, seed: int, seconds: float, traced: bool = True,
        **kw) -> tuple[dict, dict]:
    """One run of ``harness.run``: its line and its record."""
    from noc_bench import harness
    keep = {}
    line = harness.run(workload, seed, seconds, traced,
                       t0=kw.pop("t0", time.perf_counter()), keep=keep, **kw)
    return line, keep["record"]


def report(record: dict, out=None) -> None:
    """The split the program's telemetry shows, on ``out`` (standard
    error)."""
    out = out or sys.stderr
    spans = [s for s in record.get("program_spans", ())
             if s["mode"] == "spans"]
    n = len({s["request"] for s in spans}) or 1
    own = {name: span_seconds(record, name)[0]
           for name in {s["name"] for s in spans}}
    if own:
        print(f"self ms a request over {n} spans requests: " + ", ".join(
            f"{k} {1e3 * v / n:.3f}" for k, v in
            sorted(own.items(), key=lambda kv: -kv[1])), file=out)
    totals = collections.Counter()
    for c in record.get("program_counters", ()):
        if c["mode"] == "spans":
            totals.update(c["counters"])
    if totals:
        print("counters a request: " + ", ".join(
            f"{k} {v / n:.2f}" for k, v in sorted(totals.items())),
            file=out)
    prof = record.get("program_profile")
    if prof:
        print("slice idle s by program span: " + ", ".join(
            f"{k} {v:.4f}" for k, v in prof["idle_gaps"]), file=out)
        print(f"slice device ops by program span: {prof['device_ops']}, "
              f"unattributed {prof['unattributed']}", file=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    # The benchmark command's own set-up: its caches, one host thread of
    # math, the checkout and its src on the path.
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import noc_bench.run  # noqa: F401
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    line, record = run(args.workload, args.seed, args.seconds, t0=T0)
    report(record)
    print(json.dumps(line))
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
