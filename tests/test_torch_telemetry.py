"""The NoC path's telemetry (``repro_torch.telemetry``) on the CPU: off it
records no span and no kernel record, on its spans nest with the right
parent and request id, a span's self time is the span less its children,
its stamps lie on the profiler's clock, and its counters count what the
path does.  The kernel's own counters run on the card
(``tests/test_torch_kernels_hopper.py``)."""
import inspect
import time

import pytest
import torch

from repro_torch import telemetry
from repro_torch.core.experiment import Budget, Experiment, run_experiments
from repro_torch.core.spec import TopologySpec
from repro_torch.faults import measure_repair, sample_faults
from repro_torch.kernels import noc_step

torch.set_num_threads(1)
BUDGET = Budget(cycles=40, warmup=10, backend="torch", device="cpu")


@pytest.fixture(autouse=True)
def off_and_drained():
    telemetry.disable()
    telemetry.request(None)
    telemetry.drain()
    yield
    telemetry.disable()
    telemetry.request(None)
    telemetry.drain()


def grid(n=2):
    spec = TopologySpec("ring_mesh", 16)
    return [Experiment(topology=spec, budget=BUDGET, inj_rate=0.2 + 0.3 * i,
                       seed=i) for i in range(n)]


def test_off_records_no_span_and_no_kernel():
    assert not telemetry.is_on()
    with telemetry.span("a") as s:
        assert s is None
    run_experiments(grid())
    out = telemetry.drain()
    assert out["spans"] == [] and out["kernels"] == []
    # Counters are always on; drain clears them.
    assert out["counters"]["streams.points"] == 2
    assert telemetry.drain()["counters"] == {}


def by_id_of(spans, name):
    [s] = [x for x in spans if x["name"] == name]
    return s["id"]


def test_spans_nest_with_their_parent_and_request():
    telemetry.enable()
    telemetry.request(7)
    run_experiments(grid())
    telemetry.request(None)
    with telemetry.span("outside"):
        pass
    telemetry.disable()
    out = telemetry.drain()
    spans = out["spans"]
    by_id = {s["id"]: s for s in spans}

    def chain(name):
        [s] = [x for x in spans if x["name"] == name]
        names = []
        while s is not None:
            names.append(s["name"])
            s = by_id.get(s["parent"])
        return names
    assert chain("sim.draw_streams") == [
        "sim.draw_streams", "sim.batch_operands", "sim._run_core",
        "sim.run_batch", "sweep.sweep", "experiment.run_experiments"]
    assert chain("sim.build_geometry")[1:3] == ["sim.run_batch",
                                                "sweep.sweep"]
    assert [s["parent"] for s in spans
            if s["name"] == "experiment.report"] == [
        by_id_of(spans, "experiment.run_experiments")] * 2
    assert {s["request"] for s in spans if s["name"] != "outside"} == {7}
    assert [s["request"] for s in spans if s["name"] == "outside"] == [None]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        parent = by_id.get(s["parent"])
        if parent is not None:
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
    # The twin's arbitration passes of each point, as a kernel record.
    [rec] = out["kernels"]
    assert rec["name"] == "noc_step.passes" and rec["request"] == 7
    assert rec["backend"] == "torch" and rec["cycles"] == 40
    assert len(rec["passes"]) == 2 and all(p >= 40 for p in rec["passes"])


def test_self_time_is_the_span_less_its_children():
    telemetry.enable()
    with telemetry.span("outer"):
        time.sleep(0.01)
        with telemetry.span("inner"):
            time.sleep(0.02)
            with telemetry.span("leaf"):
                time.sleep(0.005)
        with telemetry.span("inner"):
            pass
    telemetry.disable()
    spans = telemetry.drain()["spans"]
    sec = {}
    for s in spans:
        sec[s["name"]] = sec.get(s["name"], 0.0) + (
            s["end_ns"] - s["start_ns"]) / 1e9
    own = telemetry.self_times(spans)
    assert own["leaf"] == pytest.approx(sec["leaf"])
    assert own["inner"] == pytest.approx(sec["inner"] - sec["leaf"])
    assert own["outer"] == pytest.approx(sec["outer"] - sec["inner"])
    assert own["outer"] >= 0.01 and own["inner"] >= 0.02


def test_spans_are_on_the_profilers_clock():
    """Under a CPU-only profiler, each span's start and end lie within 50
    microseconds of its own range's event."""
    telemetry.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with telemetry.span(f"clock.{i}"):
                torch.ones(64) + 1
                with telemetry.span(f"clock.{i}.inner"):
                    time.sleep(0.002)
            time.sleep(0.005)
    telemetry.disable()
    spans = telemetry.drain()["spans"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    assert len(spans) == len(events) == 10
    for s in spans:
        e = events[s["name"]]
        assert abs(s["start_ns"] - e.start_ns()) < 50_000, s["name"]
        assert abs(s["end_ns"] - (e.start_ns() + e.duration_ns())) \
            < 50_000, s["name"]


def test_counters_of_a_fault_scenario():
    spec = TopologySpec("ring_mesh", 64)
    flt = sample_faults(spec.build(), n_dead_links=3, seed=1)
    telemetry.drain()
    telemetry.enable()
    measure_repair(spec, flt, budget=BUDGET)
    telemetry.disable()
    out = telemetry.drain()
    names = [s["name"] for s in out["spans"]]
    assert names.count("topology.reroute_avoiding") == 1
    assert names.count("repair.measure_repair") == 1
    # Two walks in the re-routing and one in the faulted leg's
    # reachability, each of ceil(log2(L)) + 1 doublings.
    walks = names.count("topology.walk_classify")
    assert walks == 3
    assert out["counters"]["topology.walk_doublings"] % walks == 0
    # Each walk counted once, under the device it ran on: the card when
    # there is one.
    counters = out["counters"]
    assert (counters.get("topology.walks[cpu]", 0)
            + counters.get("topology.walks[cuda]", 0)) == walks
    on = "cuda" if torch.cuda.is_available() else "cpu"
    assert counters.get(f"topology.walks[{on}]", 0) == walks
    assert out["counters"]["topology.bellman_ford_rounds"] >= 2
    assert out["counters"]["streams.points"] == 3   # the three legs
    assert [k["name"] for k in out["kernels"]] == ["noc_step.passes"] * 3


def test_spanned_keeps_the_function():
    assert noc_step.run_fused.__name__ == "run_fused"
    assert "cluster_size" in inspect.signature(noc_step.run_fused).parameters
    assert noc_step.launches() == dict.fromkeys(noc_step.LAUNCH_COUNTERS, 0)
    telemetry.count(noc_step.LAUNCH_COUNTERS[noc_step.TRACE], 2)
    assert noc_step.launches()[noc_step.TRACE] == 2
    assert telemetry.counter("no.such.counter") == 0


def test_kernel_records_are_kept_only_while_on():
    t = torch.arange(3)
    telemetry.kernel("k", values=t)
    assert telemetry.drain()["kernels"] == []
    telemetry.enable()
    telemetry.request(2)
    telemetry.kernel("k", values=t, clock=None)
    telemetry.disable()
    assert telemetry.drain()["kernels"] == [
        dict(name="k", request=2, values=[0, 1, 2], clock=None)]
