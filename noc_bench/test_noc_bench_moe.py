"""The expert-parallel exchange cell at a small size on the CPU: the
program's router against the plain reference's, ties included; a whole
request (routing summary and report) against the reference's replay; the
mined collective traces replayed alike through the records form; and whole
runs with the timed path broken reading ``correct`` false.

The small size: a 64-PE ring-mesh (one domain of 64 experts, 8 groups of
8, the top 4 groups and 8 experts a token), hidden size 256, 2 tokens a
PE."""
import time

import pytest
import torch

from noc_bench import check, generator, harness, program, tracing
from noc_bench.reference import moe as ref_moe

CELL = "deepseek_v3-ring_mesh-1024.moe_decode"


def small() -> dict:
    cfg = dict(generator.load_json("configs", "deepseek_v3-ring_mesh-1024"))
    cfg["fabric"] = dict(cfg["fabric"], n_pes=64)
    cfg.update(hidden_size=256, n_routed_experts=64)
    return cfg


MIX = dict(generator.load_json("traffic", "moe_decode"), tokens_per_pe=2,
           budget={"cycles": 960, "warmup": 0})
MODEL = {k: small()[k] for k in ("hidden_size", "n_routed_experts",
                                 "num_experts_per_tok", "n_group",
                                 "topk_group", "routed_scaling_factor",
                                 "norm_topk_prob")}


def request(seed: int = 11, i: int = 0) -> dict:
    return generator.Generator(small(), MIX, seed).request(i)


def tied_logits() -> tuple[torch.Tensor, torch.Tensor]:
    """Logits and a bias on a coarse grid, so that groups and experts tie
    at the edge of what is kept; the first token ties everywhere."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randint(-2, 3, (32, 64), generator=g).float() / 4
    bias = torch.randint(-1, 2, (64,), generator=g).float() / 64
    logits[0] = 0.0
    return logits, bias


def test_the_router_equals_the_reference_ties_included():
    from repro_torch.models import layers
    logits, bias = tied_logits()
    got_w, got_e = layers.group_limited_top_k(
        logits, bias, n_group=8, topk_group=4, k=8, scaling=2.5)
    want_w, want_e = ref_moe.router(logits, bias, MODEL)
    assert torch.equal(got_e, want_e)
    assert torch.allclose(got_w, want_w, rtol=0, atol=1e-6)
    # every group and expert of the first token ties: the lowest ids win
    zero_bias = torch.zeros(64)
    _, first = layers.group_limited_top_k(
        logits[:1], zero_bias, n_group=8, topk_group=4, k=8, scaling=2.5)
    assert first.tolist() == [list(range(8))]
    # the grid does tie at the edges: some token's 8th and 9th choices of
    # its kept groups, and some token's 4th and 5th group scores, are equal
    choice = torch.sigmoid(logits) + bias
    grp = torch.sort(torch.sort(choice.view(32, 8, 8), dim=-1,
                                descending=True)[0][..., :2].sum(-1),
                     dim=-1, descending=True)[0]
    assert bool((grp[:, 3] == grp[:, 4]).any())
    assert bool((torch.sort(choice, dim=-1, descending=True)[0][:, 7]
                 == torch.sort(choice, dim=-1, descending=True)[0][:, 8]
                 ).any())


def test_the_routing_of_a_request_equals_the_reference():
    from repro_torch.trace import moe
    req = request()
    got_w, got_e = moe.route(req["model"], 64, req["tokens_per_pe"],
                             router_seed=req["router_seed"],
                             token_seed=req["point"]["seed"], device="cpu")
    want_w, want_e = ref_moe.router(*ref_moe.logits_of(req, "cpu"),
                                    req["model"])
    assert torch.equal(got_e, want_e)
    assert torch.allclose(got_w, want_w, rtol=0, atol=1e-6)


def test_the_layout_equals_the_reference_over_four_domains():
    """256 PEs, 64 experts: four domains, each a quadrant of 2 x 2 blocks
    whose PEs are not one range of ids; the records and the summary of a
    routing equal the reference's, record by record."""
    from repro_torch.trace import moe
    g = torch.Generator().manual_seed(8)
    experts = torch.stack([torch.randperm(64, generator=g)[:8]
                           for _ in range(256 * 3)])
    req = dict(request(), fabric=dict(request()["fabric"], n_pes=256),
               tokens_per_pe=3)
    phases, want = ref_moe.layout(req, experts)
    (phase, src, dst, flits), got = moe.exchange_records(
        experts, 256, 64, 3, 1, 2)
    assert {k: v.tolist() for k, v in got.items()} == want
    for ph in (0, 1):
        rows = (phase == ph).nonzero()[:, 0]
        mine = [[] for _ in range(256)]
        for s, d, f in zip(src[rows].tolist(), dst[rows].tolist(),
                           flits[rows].tolist()):
            mine[s].append((d, f))
        assert mine == phases[ph], ph
    place = moe.expert_placement(256, 64)
    assert place[1, :4].tolist() == [32, 33, 34, 35]   # block 2 of row 0
    assert place[2, 0] == 128 and place[3, 63] == 255


def run_request(req: dict) -> dict:
    """The program's outputs for ``req``, its report caught as the
    harness catches it."""
    probes = tracing.Probes(program.modules(), False, lambda: None)
    probes.captured = cap = program.Captured()
    try:
        generator.entry("moe_exchange").run(req, cap, "torch", "cpu")
    finally:
        probes.remove()
    return program.outputs(cap)


def test_a_request_equals_the_reference():
    """The records form through the plain twin against the reference's
    one-record-a-cycle replay: the summary and every report value."""
    req = request()
    got = run_request(req)
    want = ref_moe.replay(req, "cpu")
    assert check.compare(got, want) == dict.fromkeys(
        ("sim_values_differing", "report_values_differing",
         "certificate_values_differing"), 0)
    sim = got["reports"][0]["sim"]
    assert len(sim["phase_done"]) == 2 and min(sim["phase_done"]) > 0
    summary = got["summary"]
    assert sim["delivered"] == sum(summary["dispatch_flits"]) + sum(
        summary["combine_flits"])
    assert max(summary["dispatch_records"]) > 1
    assert sum(summary["expert_tokens"]) == 64 * 2 * 8
    assert 2 * sum(summary["dispatch_flits"]) == sum(
        summary["combine_flits"])


def test_a_request_routes_layer_by_layer():
    reqs = [request(3, i) for i in range(60)]
    assert [r["layer"] for r in reqs[:3]] == [3, 4, 5]
    assert reqs[58]["layer"] == 3
    assert len({r["router_seed"] for r in reqs}) == 58
    assert len({r["point"]["seed"] for r in reqs}) == 60
    assert request(3, 0) == reqs[0] and request(4, 0) != reqs[0]


def test_the_collective_traces_replay_alike_in_records_form():
    """The three mined schedules' traces, one record a source, through the
    record walk give the outputs of the one-record path."""
    from repro_torch.core import sim
    from repro_torch.core.spec import TopologySpec
    from repro_torch.kernels import noc_step
    from repro_torch.trace import extract
    topo = TopologySpec("ring_mesh", 64).build()
    geom = sim.build_geometry(topo, "cpu")
    traces = extract.traces_for_schedules(64, pod_size=16,
                                          normalize_flits=8)
    kw = dict(warmup=0, starvation_limit=8, arb_iters=sim.ARB_ITERS)
    for name, tr in traces.items():
        cfg = sim.SimConfig(cycles=300, warmup=0, inj_rate=1.0, pattern=tr,
                            backend="torch", device="cpu", seed=2)
        pt = sim.make_point(cfg, 64, topo)
        assert pt.rec_dst.shape == (0,)
        inj, dst, trace, _, _ = sim.batch_operands([pt], 64, 300, "cpu")
        want = noc_step.run_plain(geom, inj, dst, trace=trace, **kw)
        got = noc_step.run_plain(
            geom, inj, dst, trace=trace + sim.record_tables([pt], "cpu"),
            **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        assert int((want[4] >= 0).sum()) >= 3, name


def break_exchange(monkeypatch, how: str) -> None:
    from repro_torch import routing
    from repro_torch.trace import moe
    if how == "expert":
        route = routing.group_limited_top_k

        def changed(*a, **k):
            w, e = route(*a, **k)
            e = e.clone()
            taken = set(e[0].tolist())
            e[0, 0] = next(x for x in range(64) if x not in taken)
            return w, e
        monkeypatch.setattr(routing, "group_limited_top_k", changed)
        return
    records = moe.TraceRecords

    def cut(**kw):
        keep = kw["phase"] == 0 if how == "combine" else None
        if how == "truncated":
            # the last dispatch record of the first source that has two
            rows = (kw["phase"] == 0).nonzero()[0]
            src = kw["src"][rows]
            two = next(s for s in src if (src == s).sum() > 1)
            last = rows[src == two][-1]
            keep = torch.ones(len(kw["phase"]), dtype=torch.bool).numpy()
            keep[last] = False
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


@pytest.mark.parametrize("how", ["expert", "truncated", "combine"])
def test_a_broken_exchange_is_not_correct(monkeypatch, how):
    break_exchange(monkeypatch, how)
    line = run_cell()
    assert line["correct"] is False, line["check"]
    assert line["failed"] == 0


def test_a_traced_run_reports_the_routing_and_the_front_end(monkeypatch):
    """The traced line holds the two new layers' metrics, read from the
    program's ``moe.route`` and ``trace.build`` spans, and its counters."""
    from noc_bench.test_noc_bench_faults import stepped_clock
    monkeypatch.setattr(harness, "SLICE_S", 0.6)
    keep = {}
    mix = dict(MIX, budget={"cycles": 160, "warmup": 0})
    line = harness.run(CELL, 4_000_000_011, 1.5, True, t0=time.perf_counter(),
                       device="cpu", backend="torch", config=small(),
                       mix=mix, clock=stepped_clock(monkeypatch), keep=keep)
    assert line["correct"], line["check"]
    for name in ("moe.route_ms_per_request", "trace.build_ms_per_request",
                 "noc_step.passes_per_cycle", "geometry.ms_per_batch"):
        assert line["metrics"][name]["value"] > 0, name
    counters = [c["counters"] for c in keep["record"]["program_counters"]
                if c["mode"] == "spans"]
    assert counters and all(c["moe.tokens"] == 128 and c["trace.records"]
                            == c["moe.records[dispatch]"]
                            + c["moe.records[combine]"]
                            and c["moe.expert_tokens_max"] >= 16
                            for c in counters)
