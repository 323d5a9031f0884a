"""The zero-compute-expert exchange cell at a small size on the CPU: a
whole request (routing summary and report) against the reference's
replay, the requests layer by layer, whole runs reading ``correct``, and
whole runs with the timed path broken reading ``correct`` false.

The small size: a 64-PE ring-mesh (two domains of 32 experts), 32 real
and 16 identity experts, 4 choices a token, hidden size 256, 2 tokens a
PE around 64 topics."""
import time

import pytest
import torch

from noc_bench import check, generator, harness, program, tracing
from noc_bench.reference import moe_zero as ref

CELL = "longcat_flash-ring_mesh-1024.moe_decode_skewed"


def small() -> dict:
    cfg = dict(generator.load_json("configs", "longcat_flash-ring_mesh-1024"))
    cfg["fabric"] = dict(cfg["fabric"], n_pes=64)
    cfg.update(hidden_size=256, n_routed_experts=32, zero_expert_num=16,
               moe_topk=4)
    return cfg


MIX = dict(generator.load_json("traffic", "moe_decode_skewed"),
           tokens_per_pe=2, budget={"cycles": 640, "warmup": 0})


def request(seed: int = 11, i: int = 0) -> dict:
    return generator.Generator(small(), MIX, seed).request(i)


def run_request(req: dict) -> dict:
    probes = tracing.Probes(program.modules(), False, lambda: None)
    probes.captured = cap = program.Captured()
    try:
        generator.entry("moe_zero_exchange").run(req, cap, "torch", "cpu")
    finally:
        probes.remove()
    return program.outputs(cap)


def test_a_request_equals_the_reference():
    req = request()
    got = run_request(req)
    want = ref.replay(req, "cpu")
    assert check.compare(got, want) == dict.fromkeys(
        ("sim_values_differing", "report_values_differing",
         "certificate_values_differing"), 0)
    sim, summary = got["reports"][0]["sim"], got["summary"]
    assert len(sim["phase_done"]) == 2 and min(sim["phase_done"]) > 0
    assert sim["delivered"] == sum(summary["dispatch_flits"]) + sum(
        summary["combine_flits"])
    assert sum(summary["expert_tokens"]) + sum(
        summary["identity_choices"]) == 64 * 2 * 4
    assert sum(summary["identity_choices"]) > 0
    assert 2 * sum(summary["dispatch_flits"]) == sum(
        summary["combine_flits"])


def test_a_request_routes_layer_by_layer():
    reqs = [request(3, i) for i in range(30)]
    assert [r["layer"] for r in reqs[:3]] == [0, 1, 2]
    assert reqs[28]["layer"] == 0
    assert len({r["router_seed"] for r in reqs}) == 28
    assert len({r["point"]["seed"] for r in reqs}) == 30
    assert request(3, 0) == reqs[0] and request(4, 0) != reqs[0]
    assert reqs[0]["topics"] == 64 and reqs[0]["model"]["moe_topk"] == 4


def break_exchange(monkeypatch, how: str) -> None:
    from repro_torch import routing
    from repro_torch.trace import moe
    if how == "expert":
        route = routing.softmax_top_k

        def changed(*a, **k):
            w, e = route(*a, **k)
            e = e.clone()
            taken = set(e[0].tolist())
            e[0, 0] = next(x for x in range(32) if x not in taken)
            return w, e
        monkeypatch.setattr(routing, "softmax_top_k", changed)
        return
    if how == "identity_sent":
        layout = moe.exchange_records

        def sent(experts, n_pes, n_experts, *a, **k):
            # identity choices sent to the real expert of the same rank
            # where that expert is not already the token's
            e = experts.clone()
            for row in e:
                for j, x in enumerate(row.tolist()):
                    if x >= n_experts and x - n_experts not in row.tolist():
                        row[j] = x - n_experts
            return layout(e, n_pes, n_experts, *a, **k)
        monkeypatch.setattr(moe, "exchange_records", sent)
        return
    records = moe.TraceRecords

    def cut(**kw):
        keep = kw["phase"] == 0 if how == "combine" else None
        if how == "truncated":
            rows = (kw["phase"] == 0).nonzero()[0]
            src = kw["src"][rows]
            two = next(s for s in src if (src == s).sum() > 1)
            keep = torch.ones(len(kw["phase"]), dtype=torch.bool).numpy()
            keep[rows[src == two][-1]] = False
        else:
            kw["n_phases"] = 1
        for k in ("phase", "src", "dst", "flits"):
            kw[k] = kw[k][keep]
        return records(**kw)
    monkeypatch.setattr(moe, "TraceRecords", cut)


def run_cell(seed: int = 4_000_000_007) -> dict:
    return harness.run(CELL, seed, 0.3, False, t0=time.perf_counter(),
                       device="cpu", backend="torch", config=small(),
                       mix=MIX)


def test_a_sound_run_is_correct():
    line = run_cell()
    assert line["correct"] and line["requests_checked"] == 1
    assert set(line["metrics"]) == {"sim_rate", "setup_s"}


@pytest.mark.parametrize("how", ["expert", "identity_sent", "truncated",
                                 "combine"])
def test_a_broken_exchange_is_not_correct(monkeypatch, how):
    break_exchange(monkeypatch, how)
    line = run_cell()
    assert line["correct"] is False, line["check"]
    assert line["failed"] == 0


def test_a_traced_run_reports_the_draw_and_the_choices(monkeypatch):
    """The traced line holds the routing layer's metrics, read from the
    program's ``moe.draw`` and ``moe.route`` spans, the front end's, and
    the choices' counters."""
    from noc_bench.test_noc_bench_faults import stepped_clock
    monkeypatch.setattr(harness, "SLICE_S", 0.6)
    keep = {}
    mix = dict(MIX, budget={"cycles": 160, "warmup": 0})
    line = harness.run(CELL, 4_000_000_011, 1.5, True, t0=time.perf_counter(),
                       device="cpu", backend="torch", config=small(),
                       mix=mix, clock=stepped_clock(monkeypatch), keep=keep)
    assert line["correct"], line["check"]
    for name in ("moe.draw_ms_per_request", "moe.route_ms_per_request",
                 "trace.build_ms_per_request", "noc_step.passes_per_cycle",
                 "geometry.ms_per_batch"):
        assert line["metrics"][name]["value"] > 0, name
    spans = keep["record"]["program_spans"]
    parent = {s["id"]: s["name"] for s in spans}
    assert {parent[s["parent"]] for s in spans
            if s["name"] == "moe.draw"} == {"moe.route"}
    counters = [c["counters"] for c in keep["record"]["program_counters"]
                if c["mode"] == "spans"]
    assert counters and all(
        c["moe.choices[routed]"] + c["moe.choices[identity]"] == 512
        and c["moe.choices[identity]"] > 0 for c in counters)


def test_the_draw_reader_finds_nothing_without_the_span():
    """A program without the ``moe.draw`` span (the parent's) leaves the
    metric out of the line."""
    from noc_bench import program_trace
    empty = program_trace.Adapter()
    empty.tm = None
    for rec in ({}, empty.read()):
        assert harness.reader("moe.draw_ms_per_request")(rec) is None
