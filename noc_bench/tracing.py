"""The benchmark's own spans around the program's layers, the timing of
each kernel launch, and the reading of a ``torch.profiler`` slice.

``Probes`` wraps program functions for the length of a run.  Always: the
reports that ``run_experiments`` returns and the certificate that
``fabric.certify`` returns are kept for the check.  In a traced run the
harness sets ``mode`` for each request of the window
(``harness.Slice``):

* ``quiet``: nothing but the launch timing below, so these requests take
  as long as untraced ones (``job_mfu`` reads them);
* ``profiled``: as ``quiet``, and each wrapped call carries a
  ``record_function`` of its name, so the profiler's idle gaps are named
  by the layer the host was in; nothing is synchronised;
* ``spans``: as ``profiled``, and each wrapped call is a span: the device
  is synchronised before its clock stops (as ``chip_smoke.host_clock``
  does) and it records its parent span, so a layer's self time is its
  span less its children.  The synchronising slows these requests.

In every mode of a traced run, each ``noc_step`` launch is timed by CUDA
events recorded right before and after the library's launch call, so its
device time holds the kernel alone, not the host work of ``run_fused``
around it; its shapes come from ``run_fused``'s arguments.
"""
from __future__ import annotations

import bisect
import collections
import time

import torch

from . import roofline

# Span name -> (module key of ``program.modules()``, attribute).
SPANS = {
    "experiment.run_experiments": ("experiment", "run_experiments"),
    "spec.TopologySpec.build": ("TopologySpec", "build"),
    "sim.build_geometry": ("sim", "build_geometry"),
    "sim.batch_operands": ("sim", "batch_operands"),
    "noc_step.run_fused": ("noc_step", "run_fused"),
    "sim._fault_reachability": ("sim", "_fault_reachability"),
    "repair.suggest_repair_morph": ("repair", "suggest_repair_morph"),
    "repair.measure_repair": ("repair", "measure_repair"),
    "fabric.certify": ("fabric", "certify"),
}
CAPTURED = ("experiment.run_experiments", "fabric.certify")
MODES = ("quiet", "profiled", "spans")


class _TimedLibrary:
    """The kernel's library with CUDA events around each launch."""

    def __init__(self, lib, events: list):
        self._lib, self._events = lib, events

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def noc_step_launch(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = self._lib.noc_step_launch(*args)
        stop.record()
        self._events.append((start, stop))
        return err


class Probes:
    def __init__(self, modules: dict, traced: bool, sync):
        self.traced, self.sync = traced, sync
        self.captured = None          # program.Captured of the request
        self.mode, self.request = "quiet", None
        self.spans = []               # (name, parent, seconds)
        self.launches = []            # (start, stop, shape, request, mode)
        self._events = []             # events of the launches in flight
        self._stack: list[str] = []
        self._saved = []
        for name, (mod, attr) in SPANS.items():
            if traced or name in CAPTURED:
                self._patch(modules[mod], attr,
                            lambda fn, name=name: self._wrap(name, fn))
        if traced:
            self._patch(modules["noc_step"], "load_library",
                        lambda fn: lambda: _TimedLibrary(fn(),
                                                         self._events))

    def _patch(self, owner, attr: str, make) -> None:
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))
        setattr(owner, attr, make(fn))

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def clear(self) -> None:
        self.spans.clear()
        self.launches.clear()

    def _keep(self, name: str, out) -> None:
        if self.captured is None:
            return
        if name == "experiment.run_experiments":
            self.captured.reports.extend(out)
        elif name == "fabric.certify":
            self.captured.certificate = out

    def _wrap(self, name: str, fn):
        def plain(*a, **k):
            out = fn(*a, **k)
            self._keep(name, out)
            return out

        def traced(*a, **k):
            mode = self.mode
            n_events = len(self._events)
            if mode == "quiet":
                out = fn(*a, **k)
            elif mode == "profiled":
                with torch.profiler.record_function(name):
                    out = fn(*a, **k)
            else:
                parent = self._stack[-1] if self._stack else None
                self._stack.append(name)
                t = time.perf_counter()
                try:
                    with torch.profiler.record_function(name):
                        out = fn(*a, **k)
                        self.sync()
                finally:
                    self._stack.pop()
                self.spans.append((name, parent, time.perf_counter() - t))
            if name == "noc_step.run_fused":
                shape = roofline.launch_shape(a[0], a[1], k.get("trace"),
                                              k.get("faults"))
                for start, stop in self._events[n_events:]:
                    self.launches.append((start, stop, shape, self.request,
                                          mode))
                del self._events[n_events:]
            self._keep(name, out)
            return out

        return traced if self.traced else plain

    # -- totals for the metric readers ---------------------------------------
    def totals(self) -> dict:
        """``span_s[name]`` total seconds, ``calls[name]`` count, and
        ``child_s[name]`` seconds of its direct children, over the
        ``spans`` requests."""
        span_s = collections.Counter()
        calls = collections.Counter()
        child_s = collections.Counter()
        for name, parent, sec in self.spans:
            span_s[name] += sec
            calls[name] += 1
            if parent is not None:
                child_s[parent] += sec
        return dict(span_s=dict(span_s), calls=dict(calls),
                    child_s=dict(child_s))

    def launch_records(self) -> list[dict]:
        """Each launch's device seconds beside its shapes, its request and
        that request's mode (after a synchronise)."""
        return [dict(shape, device_s=a.elapsed_time(b) / 1e3, request=i,
                     mode=mode)
                for a, b, shape, i, mode in self.launches]


# -- the profiler slice -------------------------------------------------------
def _annotation(e) -> bool:
    return (e.name() in SPANS or e.name().startswith("harness.")
            or getattr(e, "is_user_annotation", lambda: False)())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans):
    """Segments of the host timeline, each named by the innermost span
    open in it (spans of one thread nest): (sorted starts, names)."""
    starts, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            starts.append(end)
            names.append(stack[-1][1] if stack else "harness")

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        stack.append((e, n))
        starts.append(s)
        names.append(n)
    close_until(float("inf"))
    return starts, names


def read_profile(prof, top: int = 10) -> dict:
    """Busy and window seconds of the slice (its ``harness.slice`` span),
    the device operations that took most time and the idle gaps by the
    innermost harness span the host was in."""
    events = list(prof.profiler.kineto_results.events())
    dev_type = torch.autograd.DeviceType.CUDA
    slice_ev = [e for e in events if e.name() == "harness.slice"]
    if not slice_ev:
        return {}
    w0 = slice_ev[0].start_ns()
    w1 = w0 + slice_ev[0].duration_ns()
    # The device's own operations: kernels, copies and sets, not the
    # device-side ranges that the harness's spans annotate.
    dev = [(max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1),
            e.name()) for e in events if e.device_type() == dev_type
           and not _annotation(e)]
    dev = [d for d in dev if d[1] > d[0]]
    by_op = collections.Counter()
    for s, e, n in dev:
        by_op[n[:120]] += (e - s) / 1e9
    busy = _merge([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    starts, names = _innermost(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        for e in events if e.device_type() != dev_type
        and (e.name() in SPANS or e.name().startswith("harness.")))
    gaps = collections.Counter()
    cursor = w0
    for s, e in busy + [[w1, w1]]:
        if s > cursor:
            at = bisect.bisect_right(starts, (cursor + s) / 2) - 1
            gaps[names[at] if at >= 0 else "harness"] += (s - cursor) / 1e9
        cursor = max(cursor, e)
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e9,
            "device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}
