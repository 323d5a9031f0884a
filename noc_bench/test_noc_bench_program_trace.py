"""The program's telemetry in a traced run (``program_trace``): its eight
readers and its helpers on a synthetic record, the attribution of a
profile's device operations and idle gaps to program spans on synthetic
events, and whole CPU runs of the harness, which turns it on in a traced
run only."""
import time

import pytest
import torch

from noc_bench import harness, program_trace
from noc_bench.test_noc_bench_faults import CELLS, small, stepped_clock

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
# The per-layer metrics that read the program's telemetry.
NAMES = ["streams.draw_ms_per_point", "streams.device_ops_per_point",
         "noc_step.passes_per_cycle", "noc_step.barrier_wait_share",
         "noc_step.host_prep_ms_per_launch", "geometry.ms_per_batch",
         "experiment.report_ms_per_point", "faults.reroute_ms_per_scenario"]
KEYS = ("program_spans", "program_counters", "program_kernels",
        "program_profile")


def span(i, name, parent, start, end, mode="spans", request=0):
    return dict(name=name, id=i, parent=parent, request=request,
                start_ns=start, end_ns=end, mode=mode)


def record():
    """Two ``spans`` requests and one ``profiled`` one."""
    spans = [
        span(0, "repair.measure_repair", None, 0, 10_000_000),
        span(1, "topology.reroute_avoiding", 0, 1_000_000, 4_000_000),
        span(2, "sim.draw_streams", 0, 4_000_000, 6_000_000),
        span(3, "noc_step.prepare", 0, 6_000_000, 6_500_000),
        span(4, "sim.build_geometry", 0, 7_000_000, 7_250_000),
        span(5, "experiment.report", 0, 8_000_000, 8_100_000),
        span(6, "experiment.report", 0, 8_100_000, 8_400_000),
        span(7, "repair.measure_repair", None, 20_000_000, 26_000_000,
             request=1),
        span(8, "sim.draw_streams", None, 0, 9_000_000, mode="profiled",
             request=2),
    ]
    counters = [dict(request=0, mode="spans",
                     counters={"streams.points": 3}),
                dict(request=1, mode="spans",
                     counters={"streams.points": 1}),
                dict(request=2, mode="profiled",
                     counters={"streams.points": 4})]
    kernels = [
        dict(name="noc_step.passes", backend="cuda", cycles=100,
             passes=[150, 250], request=0, mode="spans"),
        dict(name="noc_step.passes", backend="cuda", cycles=200,
             passes=[400], request=2, mode="profiled"),
        dict(name="noc_step.clock", cluster=2, cycles=100,
             clock=[[[30, 100], [10, 100]], [[20, 100], [0, 100]]],
             request=0, mode="spans"),
        dict(name="noc_step.clock", cluster=1, cycles=100, clock=None,
             request=1, mode="spans"),
    ]
    return dict(program_spans=spans, program_counters=counters,
                program_kernels=kernels,
                program_profile={"device_ops": {"sim.draw_streams": 8400},
                                 "unattributed": 0, "idle_gaps": []})


def test_each_reader_on_a_synthetic_record():
    rec = record()
    got = {n: harness.reader(n)(rec) for n in NAMES}
    assert got == pytest.approx({
        "streams.draw_ms_per_point": 2.0 / 4,         # spans requests only
        "streams.device_ops_per_point": 8400 / 4,     # the profiled one
        "noc_step.passes_per_cycle": (150 + 250 + 400) / (2 * 100 + 200),
        "noc_step.barrier_wait_share": 100 * 60 / 400,
        "noc_step.host_prep_ms_per_launch": 0.5,
        "geometry.ms_per_batch": 0.25,
        "experiment.report_ms_per_point": 0.2,
        "faults.reroute_ms_per_scenario": 3.0 / 2,
    })


def test_span_seconds_and_counted():
    """Self seconds leave out the direct children; total seconds hold
    them; only the ``spans`` requests count by default."""
    rec = record()
    own, total = program_trace.span_seconds(rec, "repair.measure_repair")
    assert total == pytest.approx(16e-3)
    assert own == pytest.approx(16e-3 - (3 + 2 + 0.5 + 0.25 + 0.4) * 1e-3)
    assert program_trace.span_seconds(rec, "sim.draw_streams") == \
        pytest.approx((2e-3, 2e-3))
    assert program_trace.span_seconds(rec, "sim.draw_streams",
                                      "profiled") == pytest.approx(
        (9e-3, 9e-3))
    assert program_trace.span_seconds(rec, "no.such_span") is None
    assert program_trace.counted(rec, "streams.points") == 4
    assert program_trace.counted(rec, "streams.points", "profiled") == 4
    assert program_trace.counted(rec, "no.such_counter") == 0


def test_each_reader_finds_nothing_in_a_record_without_telemetry():
    """A program without the telemetry (the parent's) leaves the keys
    out, or empty: every reader returns None."""
    empty = program_trace.Adapter()
    empty.tm = None
    for rec in ({}, empty.read()):
        for n in NAMES:
            assert harness.reader(n)(rec) is None, n


def test_the_metrics_are_a_manifests_entries():
    """Each metric that reads the program's keys is a per-layer entry of
    the manifest that lists its cells: every cell for all but the fault
    scenarios' re-routing."""
    man = harness.manifest()
    cells = {w["name"] for w in man["workloads"]}
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in NAMES:
        m = entries[name]
        assert m["source"] in ("program_span", "program_counter",
                               "device_trace")
        assert m["moves"] == "sim_rate"
        want = ({"ring_mesh-1024.resilience"} if name.startswith("faults.")
                else cells)
        assert set(m["workloads"]) == want, name
        assert callable(harness.reader(name))


class Event:
    def __init__(self, name, dev, start, dur, corr=0, user=False):
        self._v = (name, dev, start, dur, corr, user)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_attribute_by_launch_call_and_innermost_span():
    spans = [span(1, "outer", None, 100, 1000, mode="profiled"),
             span(2, "inner", 1, 200, 400, mode="profiled"),
             span(3, "inner", 1, 600, 700, mode="profiled")]
    events = [
        Event("harness.slice", CPU, 50, 1150),
        Event("cudaLaunchKernel", CPU, 250, 5, corr=11),  # in inner
        Event("cudaLaunchKernel", CPU, 650, 5, corr=12),  # in inner
        Event("cudaMemcpyAsync", CPU, 500, 5, corr=13),   # outer only
        Event("aten::add", CPU, 900, 5, corr=14),         # not a launch
        Event("k1", CUDA, 300, 100, corr=11),
        Event("k2", CUDA, 700, 100, corr=12),
        Event("copy", CUDA, 800, 50, corr=13),
        Event("k3", CUDA, 1100, 50, corr=14),
        Event("outer", CUDA, 300, 600, user=True),        # an annotation
        Event("k4", CUDA, 1300, 10, corr=15),             # past the slice
    ]
    got = program_trace.attribute(events, spans)
    assert got["device_ops"] == {"inner": 2, "outer": 3}
    assert got["unattributed"] == 1
    # Busy [300, 400], [700, 850], [1100, 1150] in the slice [50, 1200]:
    # gaps at 50-300 (mid 175: outer), 400-700 (mid 550: outer),
    # 850-1100 (mid 975: outer), 1150-1200 (harness).
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"outer": 800e-9, "harness": 50e-9})
    assert program_trace.attribute(events, []) == {}


def cpu_run(which, traced, seconds=2.0, **kw):
    """``program_trace.run`` on the CPU: the line and the record."""
    name, family, mix = CELLS[which]
    return program_trace.run(name, 4_000_000_011, seconds, traced,
                             t0=time.perf_counter(), device="cpu",
                             backend="torch", config=small(family),
                             mix=mix, **kw)


def test_a_traced_cpu_run_reports_the_program_metrics(monkeypatch, capsys):
    monkeypatch.setattr(harness, "SLICE_S", 0.6)
    line, rec = cpu_run("grid", True, clock=stepped_clock(monkeypatch))
    assert line["correct"], line["check"]
    assert set(KEYS) <= set(rec)
    got = line["metrics"]
    for name in ("streams.draw_ms_per_point", "noc_step.passes_per_cycle",
                 "geometry.ms_per_batch", "experiment.report_ms_per_point"):
        assert got[name]["value"] > 0, name
    # No device, no kernel: the CPU's twin has no clock, no launch
    # preparation, no device operation; and the grid has no scenario.
    for name in ("streams.device_ops_per_point",
                 "noc_step.barrier_wait_share",
                 "noc_step.host_prep_ms_per_launch",
                 "faults.reroute_ms_per_scenario"):
        assert name not in got, name
    assert got["streams.draw_ms_per_point"]["value"] <= \
        got["streams.ms_per_point"]["value"]
    modes = {s["mode"] for s in rec["program_spans"]}
    assert modes == {"spans", "profiled"}
    assert {c["mode"] for c in rec["program_counters"]} == modes
    # The quiet requests ran with telemetry off: no record of theirs.
    quiet = {r["index"] for r in rec["requests"] if r["mode"] == "quiet"}
    assert quiet and not quiet & {s["request"]
                                  for s in rec["program_spans"]}
    program_trace.report(rec)
    assert "self ms a request" in capsys.readouterr().err


def test_an_untraced_run_never_turns_telemetry_on(monkeypatch):
    from repro_torch import telemetry
    calls, made = [], []
    monkeypatch.setattr(telemetry, "enable", lambda: calls.append(1))
    monkeypatch.setattr(program_trace, "Adapter",
                        lambda: made.append(1))
    line, rec = cpu_run("grid", False, seconds=0.3)
    assert line["correct"] and calls == [] and made == []
    assert not set(KEYS) & set(rec)
    assert not set(NAMES) & set(line["metrics"])


def test_a_traced_replay_reports_its_layers(monkeypatch):
    """The trace-replay cell's traced line holds each per-layer metric that
    lists it and reads something on the CPU, and no fault scenario's."""
    monkeypatch.setattr(harness, "SLICE_S", 0.6)
    line, rec = cpu_run("replay", True, clock=stepped_clock(monkeypatch))
    assert line["correct"], line["check"]
    listed = {m["name"] for m in harness.metrics_of(
        harness.manifest(), "ring_mesh-1024.collectives", True)}
    on_cpu = {"streams.ms_per_point", "experiment.self_ms_per_point",
              "streams.draw_ms_per_point", "noc_step.passes_per_cycle",
              "geometry.ms_per_batch", "experiment.report_ms_per_point"}
    assert on_cpu <= listed
    assert not {n for n in listed if n.startswith(("faults.", "fabric."))}
    assert set(line["metrics"]) == on_cpu
    assert rec["program_kernels"] and all(
        k["cycles"] == 150 for k in rec["program_kernels"])
