"""The NoC path's own spans, counters and kernel records.

Off by default.  Off, ``span(name)`` and ``spanned(name)`` cost one test
of a module flag and record nothing.  ``enable()`` turns them on: each
span then records its name, its id and its parent's, the request id set
by ``request(i)``, and its start and end, and opens a profiler range of
its own name, so a running ``torch.profiler`` sees it.  The range is the
RecordFunction behind ``torch.profiler.record_function``, entered
directly (``_RecordFunctionFast``: ~1 us, where ``record_function``'s
operator dispatch takes ~10); kineto lists it as a ``cpu_op`` event of
the span's name, and it puts no range on the device's timeline.
Counters (``count``) are always on: one integer each, added on the host.
Kernel records (``kernel``) are kept only while on; they may hold device
tensors, which ``drain()`` reads, so drain after synchronising the
device, never inside a span.

The clock is the profiler's: kineto stamps its events in ns of the epoch
(``time.time_ns``).  Spans are stamped with ``time.perf_counter_ns``,
which is monotonic and cheap, shifted by the offset between the two
clocks taken at ``enable()``.  A span is stamped inside its profiler
range (after entering, before leaving it), so its interval lies within
its range's event.

One thread: spans nest on one stack.  ``drain()`` returns the spans, the
counters and the kernel records as plain dicts and clears all three.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import time

import torch

_on = False
_offset_ns = 0
_request = None
_stack: list[int] = []
_spans: list[tuple] = []
_counters: dict[str, int] = {}
_kernels: list[dict] = []
_ids = itertools.count()
_NULL = contextlib.nullcontext()

try:  # the profiler range without an operator dispatch of its own
    from torch._C._profiler import _RecordFunctionFast as _range
except ImportError:  # pragma: no cover - an older torch
    _range = torch.profiler.record_function


def _clock_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few paired reads."""
    best = None
    for _ in range(7):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def enable() -> None:
    global _on, _offset_ns
    _offset_ns = _clock_offset()
    _on = True


def disable() -> None:
    global _on
    _on = False


def is_on() -> bool:
    return _on


def request(i) -> None:
    """Tag the spans that follow with request id ``i`` (None: untagged)."""
    global _request
    _request = i


class _Span:
    __slots__ = ("name", "range", "id", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = _range(self.name)
        self.range.__enter__()
        self.id = next(_ids)
        self.parent = _stack[-1] if _stack else None
        _stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack.pop()
        _spans.append((self.name, self.id, self.parent, _request,
                       self.start + _offset_ns, end + _offset_ns))
        self.range.__exit__(*exc)


def span(name: str):
    """A context manager: a span of ``name`` while on, else nothing."""
    return _Span(name) if _on else _NULL


def spanned(name: str):
    """Decorator: each call of the function is a span of ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` since the last ``drain()``."""
    return _counters.get(name, 0)


def kernel(name: str, **fields) -> None:
    """Keep a record of a kernel launch while on: plain values, or device
    tensors that ``drain()`` reads."""
    if _on:
        _kernels.append(dict(fields, name=name, request=_request))


def drain() -> dict:
    """``{"spans", "counters", "kernels"}`` as plain values, and clear
    them.  Span times are ns on the profiler's clock."""
    spans = [dict(name=n, id=i, parent=p, request=r,
                  start_ns=s, end_ns=e)
             for n, i, p, r, s, e in _spans]
    kernels = [{k: v.tolist() if isinstance(v, torch.Tensor) else v
                for k, v in rec.items()} for rec in _kernels]
    out = dict(spans=spans, counters=dict(_counters), kernels=kernels)
    _spans.clear()
    _counters.clear()
    _kernels.clear()
    return out


def self_times(spans: list[dict]) -> dict[str, float]:
    """Seconds of each span name less its direct children's, summed over
    ``spans`` (``drain()``'s)."""
    own: dict[str, float] = {}
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        sec = (s["end_ns"] - s["start_ns"]) / 1e9
        own[s["name"]] = own.get(s["name"], 0.0) + sec
        parent = by_id.get(s["parent"])
        if parent is not None:
            own[parent["name"]] = own.get(parent["name"], 0.0) - sec
    return own
