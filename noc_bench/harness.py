"""One run of one cell: set-up, the measured window, the check, the line.

The cell (``--workload``) names a configuration and a traffic mix in
``BENCHMARK.json``; their files, and a reader per metric under
``metrics/<name>.py``, are found by name.  A run is a closed loop with one
caller, the researcher's script: it sends request ``i + 1`` when request
``i`` is back.  The window ends at the first request to complete at or
after ``seconds``; rates divide all the work completed by that whole
elapsed time.  A mix's ``entry`` is a file of its own,
``entries/<entry>.py`` (see ``generator``).  After the window the peak
device memory is read, the program's state freed, and a sample of the
window's requests drawn from the seed is worked out again by the plain
reference and compared.

A traced run also turns the program's own telemetry on for its ``spans``
and ``profiled`` requests (``program_trace.Adapter``) and keeps what it
drained under the record's ``program_spans``, ``program_counters``,
``program_kernels`` and ``program_profile``; an untraced run never turns
it on.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from . import check, generator, program, program_trace, tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The profiled slice covers the whole requests that start in the window's
# last this many seconds, and the last to end.
SLICE_S = 3.0


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(man: dict, name: str) -> tuple[dict, dict]:
    """The workload entry of ``name`` and its configuration entry."""
    wl = {w["name"]: w for w in man["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(w['name'] for w in man['workloads'])}")
    cfg = {c["name"]: c for c in man["configs"]}[wl["config"]]
    return wl, cfg


def metrics_of(man: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with tracing its per-layer ones."""
    group = man["per_layer"] if traced else man["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", (workload,))]


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"noc_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the
    reference package's (``repro_torch`` is neither)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t0: float, device: str = "cuda", backend: str = "cuda",
        config: dict | None = None, mix: dict | None = None,
        clock=time.perf_counter, keep: dict | None = None) -> dict:
    """The result line of one run (``correct`` and the check's numbers
    under ``check``).  ``config`` and ``mix`` replace the cell's files,
    ``device`` / ``backend`` the card, and ``clock`` the window's clock,
    in the CPU tests only; ``keep`` receives the run's record under
    ``"record"``."""
    man = manifest()
    wl, cfg_entry = cell(man, workload)
    if config is None:
        with open(os.path.join(ROOT, cfg_entry["file"])) as f:
            config = json.load(f)
    mix = mix or generator.load_json("traffic", wl["traffic"])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    mods = program.modules()
    program.load(backend)
    gen = generator.Generator(config, mix, seed)
    entry = gen.entry
    probes = tracing.Probes(mods, traced, sync)
    adapter = program_trace.Adapter() if traced else None
    prof = None
    try:
        probes.captured = program.Captured()
        for req in gen.warmups():
            entry.run(req, probes.captured, backend, device)
        sync()
        probes.clear()
        setup_s = time.perf_counter() - t0

        records, done = [], []
        prof = Slice(on_card, seconds, clock) if traced else None

        def step(i: int, now: float) -> None:
            req = gen.request(i)
            if prof is not None:
                probes.mode = prof.enter(now)
                adapter.begin(i, probes.mode)
            cap = program.Captured()
            probes.captured, probes.request = cap, i
            t = time.perf_counter()
            try:
                with torch.profiler.record_function("harness.request"):
                    entry.run(req, cap, backend, device)
                    sync()
                ok = True
            except Exception:  # an answer that never comes
                traceback.print_exc()
                ok = False
            if adapter is not None:
                adapter.end()
            records.append(dict(index=i, ok=ok, mode=probes.mode,
                                latency_s=time.perf_counter() - t,
                                work=entry.work(req) if ok else 0,
                                points=entry.points(req) if ok else 0))
            if ok:
                done.append((req, cap))

        elapsed = window(step, seconds, clock,
                         after=prof.leave if prof is not None else None,
                         pending=prof.pending if prof is not None else None)
        sync()
    finally:
        probes.remove()
        if adapter is not None:
            adapter.end()
        if prof is not None:
            prof.close()
    failed = sum(not r["ok"] for r in records)

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    profile = prof.read() if prof is not None else {}
    record = dict(setup_s=setup_s, elapsed_s=elapsed, requests=records,
                  launches=probes.launch_records() if traced else [],
                  profile=profile, **probes.totals())
    if adapter is not None:
        record.update(adapter.read(prof.prof))
    if keep is not None:
        keep["record"] = record
    metrics = {}
    for m in metrics_of(man, workload, traced):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced:
        for mode in tracing.MODES:
            lat = [r["latency_s"] for r in records if r["mode"] == mode]
            if lat:
                print(f"{mode} requests: {len(lat)}, mean latency "
                      f"{sum(lat) / len(lat):.4f} s", file=sys.stderr)
            runs = [s for s in record["launches"] if s["mode"] == mode]
            if runs:
                us = 1e6 * (sum(s["device_s"] for s in runs)
                            / sum(s["cycles"] for s in runs))
                print(f"{mode} launches: {len(runs)}, {us:.3f} us a "
                      "cycle", file=sys.stderr)

    program.free()
    del probes
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    counts = dict.fromkeys(check.LIMITS, 0)
    counts["requests_failed"] = failed
    rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
    k = min(check.SAMPLE, len(done))
    for j in sorted(rng.choice(len(done), size=k, replace=False)):
        req, cap = done[j]
        for key, n in check.compare(program.outputs(cap),
                                    entry.reference(req, device)).items():
            counts[key] += n
    verdict = check.verdict(counts)
    print(f"set-up {setup_s:.3f} s, window {elapsed:.3f} s over "
          f"{len(records)} requests, check of {k} request(s) "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name() if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced and profile:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
    line = {"correct": verdict["correct"] and k > 0,
            "attempted": len(records), "failed": failed,
            "metrics": metrics, "device": dev}
    if traced and profile:
        line["breakdown"] = {"device_ops": profile["device_ops"],
                             "idle_gaps": profile["idle_gaps"]}
    line["requests_checked"] = k
    line["check"] = verdict["numbers"]
    return line


def window(step, seconds: float, clock=time.perf_counter,
           after=None, pending=None) -> float:
    """Call ``step(i, now)`` for i = 0, 1, ... in a closed loop until the
    first call that ends at or after ``seconds``; ``after(now, last)``
    runs after each call.  Returns the elapsed time up to that end.  While
    ``pending()`` is true the window stays open (a traced window's
    profiled slice has yet to run its length)."""
    w0 = clock()
    i = 0
    while True:
        step(i, clock() - w0)
        i += 1
        now = clock() - w0
        last = now >= seconds and not (pending is not None and pending())
        if after is not None:
            after(now, last)
        if last:
            return now


class Slice:
    """The modes of a traced window's requests (``tracing.Probes``): the
    first third ``quiet``, then ``spans``, and from the first request to
    start at or after ``SLICE_S`` before the window's end, ``profiled``,
    inside one ``harness.slice`` span of the profiler.  The profiler comes
    last and is started nowhere before it: once its tracer is attached,
    every later launch pays for it.  Its start takes seconds, so the
    window stays open until the slice holds ``SLICE_S`` of requests."""

    def __init__(self, on_card: bool, seconds: float,
                 clock=time.perf_counter):
        self.on_card, self.clock = on_card, clock
        self.spans_at = seconds / 3
        self.start_at = max(seconds - SLICE_S, self.spans_at)
        self.prof = self.span = self.t0 = None

    def enter(self, now: float) -> str:
        """The mode of the request that starts at ``now``."""
        if now < self.spans_at:
            return "quiet"
        if self.prof is None and now >= self.start_at:
            self.prof = _profiler(self.on_card)
            self.prof.start()
            self.span = torch.profiler.record_function("harness.slice")
            self.span.__enter__()
            self.t0 = self.clock()
        return "spans" if self.prof is None else "profiled"

    def pending(self) -> bool:
        """The profiled slice has not yet held ``SLICE_S`` of requests."""
        return self.prof is None or self.clock() - self.t0 < SLICE_S

    def leave(self, now: float, last: bool) -> None:
        if last:
            self.close()

    def close(self) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
            if self.on_card:
                torch.cuda.synchronize()
            self.prof.stop()

    def read(self) -> dict:
        return {} if self.prof is None else tracing.read_profile(self.prof)


def _profiler(on_card: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
