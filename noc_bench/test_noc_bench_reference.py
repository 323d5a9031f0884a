"""The frozen plain reference equals the program, field for field, on the
program's plain twin (``backend="torch"``) on the CPU: a small grid on both
fabrics, fault scenarios and schedule replays at 64 PEs.  And the control,
the reference in bfloat16, does not: the comparison that decides
``correct`` fails it."""
import json
import os

import numpy as np
import pytest

from noc_bench import check, generator, harness, program, tracing
from noc_bench.reference import collectives, noc


def small(family: str) -> dict:
    cfg = dict(generator.load_json("configs", f"{family}-1024"))
    cfg["fabric"] = dict(cfg["fabric"], n_pes=64)
    cfg["cycles"], cfg["warmup"] = 160, 40
    return cfg


GRID = dict(generator.load_json("traffic", "paper_grid"),
            inj_rates=[0.25, 1.0])
REPAIR = dict(generator.load_json("traffic", "resilience"),
              budget={"cycles": 200, "warmup": 0}, inj_rates=[0.1])
REPLAY = dict(generator.load_json("traffic", "collectives"),
              budget={"cycles": 400, "warmup": 0})
MINED = os.path.join(harness.ROOT, "experiments", "hillclimb",
                     "collective_schedules.json")


def programs_outputs(req: dict) -> dict:
    probes = tracing.Probes(program.modules(), False, lambda: None)
    try:
        cap = probes.captured = program.Captured()
        generator.entry(req["entry"]).run(req, cap, "torch", "cpu")
    finally:
        probes.remove()
    return program.outputs(cap)


def requests(family: str, mix: dict, seed: int, n: int) -> list[dict]:
    g = generator.Generator(small(family), mix, seed)
    return [g.request(i) for i in range(n)]


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_grid_equals_the_program(family):
    req, = requests(family, GRID, 91, 1)
    got = programs_outputs(req)
    want = noc.grid(req, "cpu")
    assert len(got["reports"]) == len(want["reports"]) == 6
    assert check.compare(got, want) == dict.fromkeys(
        ("sim_values_differing", "report_values_differing",
         "certificate_values_differing"), 0)
    assert sum(r["sim"]["delivered"] for r in want["reports"]) > 0


@pytest.mark.parametrize("i", [0, 1, 2])
def test_fault_scenario_equals_the_program(i):
    req = requests("ring_mesh", REPAIR, 17, 3)[i]
    got = programs_outputs(req)
    want = noc.repair(req, "cpu")
    assert len(want["reports"]) == 3 and want["certificate"]["n_edges"]
    assert got["certificate"]["properties"] == want["certificate"][
        "properties"]
    assert check.compare(got, want) == dict.fromkeys(
        ("sim_values_differing", "report_values_differing",
         "certificate_values_differing"), 0)
    faulted = want["reports"][1]["sim"]
    assert faulted["reachability"] < 1.0 and faulted["dropped"] > 0


@pytest.mark.parametrize("i", [0, 1, 2])
def test_replay_equals_the_program(i):
    """Request ``i`` replays schedule ``i mod 3``; within 400 cycles at 64
    PEs the hierarchical one completes, the others part way."""
    req = requests("ring_mesh", REPLAY, 29, 3)[i]
    assert req["schedule"] == REPLAY["order"][i]
    got = programs_outputs(req)
    want = collectives.replay(req, "cpu")
    assert len(got["reports"]) == len(want["reports"]) == 1
    assert check.compare(got, want) == dict.fromkeys(
        ("sim_values_differing", "report_values_differing",
         "certificate_values_differing"), 0)
    done = want["reports"][0]["sim"]["phase_done"]
    assert done[0] > 0 and (done[-1] > 0) == (req["schedule"] == "hier")


def test_a_replay_does_not_depend_on_its_point_seed():
    """At ``inj_rate`` 1.0 every draw of the injection stream is below
    the rate and the phase tables set every destination: two requests of
    one schedule with different point seeds replay alike."""
    a, b = requests("ring_mesh", REPLAY, 31, 4)[0::3]
    assert a["schedule"] == b["schedule"]
    assert a["point"]["seed"] != b["point"]["seed"]
    assert collectives.replay(a, "cpu") == collectives.replay(b, "cpu")


def test_the_mix_holds_the_mined_schedules_and_their_traces(monkeypatch):
    """The mix's censuses are the mined file's, and at 1024 PEs the
    reference's phase tables and the trace the program builds in the
    timed path are ``traces_for_schedules``' own."""
    from repro_torch.trace import extract
    with open(MINED) as f:
        assert REPLAY["schedules"] == json.load(f)
    want = extract.traces_for_schedules(1024, MINED, pod_size=16,
                                        normalize_flits=8)
    assert sorted(want) == sorted(REPLAY["order"])
    m = program.modules()
    built = []
    monkeypatch.setattr(m["experiment"], "run_experiments", built.extend)
    cfg = generator.load_json("configs", "ring_mesh-1024")
    g = generator.Generator(cfg, REPLAY, 3)
    for i, name in enumerate(REPLAY["order"]):
        req = g.request(i)
        generator.entry("trace_replay").run(req, None, "torch", "cpu")
        assert built[i].traffic.trace == want[name].trace
        dst, flits = collectives.tables(req)
        want_dst, want_flits = want[name].trace_arrays(1024)
        assert np.array_equal(flits, want_flits)
        assert np.array_equal(dst[flits > 0], want_dst[want_flits > 0])
    assert [len(b.traffic.trace.phases) for b in built] == [20, 20, 16]


@pytest.mark.parametrize("family,mix", [("ring_mesh", GRID),
                                        ("flat_mesh", GRID),
                                        ("ring_mesh", REPAIR),
                                        ("ring_mesh", REPLAY)])
def test_the_bfloat16_control_is_not_correct(family, mix):
    req, = requests(family, mix, 23, 1)
    run = generator.entry(mix["entry"]).reference
    counts = check.compare(run(req, "cpu", "bfloat16"), run(req, "cpu"))
    counts["requests_failed"] = 0
    assert counts["sim_values_differing"] > 0
    assert not check.verdict(counts)["correct"]
