"""The frozen plain reference equals the program, field for field, on the
program's plain twin (``backend="torch"``) on the CPU: a small grid on both
fabrics and fault scenarios at 64 PEs.  And the control, the reference in
bfloat16, does not: the comparison that decides ``correct`` fails it."""
import pytest

from noc_bench import check, generator, program, tracing
from noc_bench.reference import noc


def small(family: str) -> dict:
    cfg = dict(generator.load_json("configs", f"{family}-1024"))
    cfg["fabric"] = dict(cfg["fabric"], n_pes=64)
    cfg["cycles"], cfg["warmup"] = 160, 40
    return cfg


GRID = dict(generator.load_json("traffic", "paper_grid"),
            inj_rates=[0.25, 1.0])
REPAIR = dict(generator.load_json("traffic", "resilience"),
              budget={"cycles": 200, "warmup": 0}, inj_rates=[0.1])


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


@pytest.mark.parametrize("family,mix", [("ring_mesh", GRID),
                                        ("flat_mesh", GRID),
                                        ("ring_mesh", REPAIR)])
def test_the_bfloat16_control_is_not_correct(family, mix):
    req, = requests(family, mix, 23, 1)
    run = generator.entry(mix["entry"]).reference
    counts = check.compare(run(req, "cpu", "bfloat16"), run(req, "cpu"))
    counts["requests_failed"] = 0
    assert counts["sim_values_differing"] > 0
    assert not check.verdict(counts)["correct"]
