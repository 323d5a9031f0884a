"""LongCat-Flash's exchange in the MoE trace front end (``trace.moe``): the
softmax router over real and identity experts, topic-skewed tokens, and a
layout in which an identity choice sends nothing, against the plain
reference ``noc_bench/reference/moe_zero.py``; and DeepSeek-V3's path as
it was.

The CPU size: a 64-PE ring-mesh, 32 real and 16 identity experts, 4
choices a token, two EP domains of 32 (each a column of two blocks),
hidden size 256.  On the card (``cuda``-marked, skipped here) one request
of the benchmark's cell at 1024 PEs equals the reference exactly.  This
file imports no jax, so on the card it runs without the suite's
conftest::

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q \\
        tests/test_torch_moe_zero.py
"""
import hashlib

import numpy as np
import pytest
import torch

from noc_bench import check, generator, program, tracing
from noc_bench.reference import moe_zero as ref
from repro_torch import routing, telemetry
from repro_torch.trace import moe

CELL_CONFIG = "longcat_flash-ring_mesh-1024"
CELL_MIX = "moe_decode_skewed"
MODEL = dict(hidden_size=256, n_routed_experts=32, zero_expert_num=16,
             zero_expert_type="identity", moe_topk=4,
             routed_scaling_factor=6)
BYTES = dict(dispatch_bytes=6336, combine_bytes=12288, scale=198.0)


def small_request(seed: int = 11, i: int = 0, tokens_per_pe: int = 2):
    cfg = dict(generator.load_json("configs", CELL_CONFIG), **MODEL)
    cfg["fabric"] = dict(cfg["fabric"], n_pes=64)
    mix = dict(generator.load_json("traffic", CELL_MIX),
               tokens_per_pe=tokens_per_pe,
               budget={"cycles": 960, "warmup": 0})
    return generator.Generator(cfg, mix, seed).request(i)


def program_routing(req: dict, topics="request"):
    return moe.route(req["model"], req["fabric"]["n_pes"],
                     req["tokens_per_pe"], router_seed=req["router_seed"],
                     token_seed=req["point"]["seed"], device="cpu",
                     topics=req["topics"] if topics == "request" else topics)


def test_the_router_and_the_draws_equal_the_reference():
    req = small_request()
    got_w, got_e = program_routing(req)
    want_w, want_e = ref.router(*ref.logits_of(req, "cpu"), req["model"])
    assert torch.equal(got_e, want_e)
    assert torch.allclose(got_w, want_w, rtol=0, atol=1e-12)
    assert got_e.shape == (64 * 2, 4) and int(got_e.max()) < 48
    # every choice is a real or an identity expert, and both occur
    assert bool((got_e >= 32).any()) and bool((got_e < 32).any())
    assert ref.zipf_bounds(64).tolist() == moe.topic_bounds(64).tolist()


def test_the_router_breaks_ties_to_the_lower_id():
    logits = torch.zeros(3, 48)
    logits[1, 40] = 1.0
    bias = torch.zeros(48)
    bias[7] = 2.0 ** -17
    w, e = routing.softmax_top_k(logits, bias, k=4, scaling=6.0)
    assert e.tolist() == [[7, 0, 1, 2], [40, 7, 0, 1], [7, 0, 1, 2]]
    assert w.dtype == torch.float64
    assert torch.allclose(w[0, 1:], torch.full((3,), 6.0 / 48,
                                               dtype=torch.float64))
    want_w, want_e = ref.router(logits, bias, MODEL)
    assert torch.equal(e, want_e) and torch.allclose(w, want_w)


def test_the_layout_equals_the_reference():
    req = small_request(tokens_per_pe=3)
    _, experts = program_routing(req)
    phases, want = ref.layout(req, experts)
    (phase, src, dst, flits), got = moe.exchange_records(
        experts, 64, 32, 3, 1, 2, identity=True)
    assert {k: v.tolist() for k, v in got.items()} == want
    for ph in (0, 1):
        rows = (phase == ph).nonzero()[:, 0]
        mine = [[] for _ in range(64)]
        for s, d, f in zip(src[rows].tolist(), dst[rows].tolist(),
                           flits[rows].tolist()):
            mine[s].append((d, f))
        assert mine == phases[ph], ph
    place = moe.expert_placement(64, 32)
    assert place[0, :17].tolist() == list(range(16)) + [32]
    assert place[1, 0] == 16 and place[1, 31] == 63


def test_an_identity_choice_makes_no_record():
    """Every choice reaches a real expert or counts as an identity choice;
    each record's tokens are real choices of another PE, and a source
    whose every choice is an identity expert sends nothing."""
    req = small_request()
    _, experts = program_routing(req)
    experts = experts.clone()
    experts[:2] = torch.arange(32, 36)          # PE 0: identity only
    (phase, src, dst, flits), s = moe.exchange_records(
        experts, 64, 32, 2, 1, 2, identity=True)
    t_k = 64 * 2 * 4
    assert int(s["expert_tokens"].sum() + s["identity_choices"].sum()) == t_k
    assert int(s["identity_choices"].sum()) == int((experts >= 32).sum())
    assert int(s["identity_choices"][0]) == 8
    assert int(s["dispatch_records"][0]) == 0 and not bool((src[phase == 0]
                                                            == 0).any())
    place = moe.expert_placement(64, 32)
    real = {int(p) for p in place.reshape(-1)}
    assert set(dst.tolist()) <= real and bool((src != dst).all())
    # dispatch carries each real choice that leaves its PE, one flit each
    dom = torch.empty(64, dtype=torch.long)
    dom[torch.as_tensor(place).reshape(-1).long()] = torch.arange(
        2).repeat_interleave(32)
    pe = torch.arange(64).repeat_interleave(8)
    home = torch.as_tensor(place)[dom[pe], experts.reshape(-1).clamp(
        max=31)]
    leaving = (experts.reshape(-1) < 32) & (home != pe)
    assert int(flits[phase == 0].sum()) == int(leaving.sum())
    assert int(flits[phase == 1].sum()) == 2 * int(leaving.sum())
    # without ``identity`` the summary keeps DeepSeek-V3's fields only
    _, plain = moe.exchange_records(experts, 64, 32, 2, 1, 2)
    assert "identity_choices" not in plain


def test_the_topic_draw_is_deterministic_and_skewed():
    a = moe.draw_hidden(512, 256, 7, "cpu",
                        moe.draw_router(256, 48, 3, "cpu", topics=64)[2])
    b = moe.draw_hidden(512, 256, 7, "cpu",
                        moe.draw_router(256, 48, 3, "cpu", topics=64)[2])
    assert torch.equal(a, b)
    assert float(a.min()) >= -1.0 and float(a.max()) <= 7 / 8
    assert bool(((a * 8).round() == a * 8).all())
    # the first topic takes ~21 % of the tokens (Zipf 1.0 over 64)
    bounds = moe.topic_bounds(64)
    assert bounds[0] == int(2 ** 24 / sum(1 / (j + 1) for j in range(64)))
    req = small_request(tokens_per_pe=16)
    hot = {}
    for topics in (64, None):
        _, e = program_routing(req, topics)
        _, s = moe.exchange_records(e, 64, 32, 16, 1, 2, identity=True)
        load = s["expert_tokens"].double()
        hot[topics] = float(load.max() / load.mean())
    assert hot[64] > 1.2 * hot[None], hot


def test_the_exchange_counts_its_choices():
    telemetry.drain()
    _, s = moe.moe_exchange_trace(MODEL, 64, 2, router_seed=5, token_seed=6,
                                  device="cpu", topics=64, **BYTES)
    c = telemetry.drain()["counters"]
    assert c["moe.choices[routed]"] == sum(s["expert_tokens"])
    assert c["moe.choices[identity]"] == sum(s["identity_choices"])
    assert c["moe.choices[routed]"] + c["moe.choices[identity]"] == 512
    with pytest.raises(ValueError, match="identity"):
        moe.route(dict(MODEL, zero_expert_type="constant"), 64, 2,
                  router_seed=5, token_seed=6, device="cpu")


# The DeepSeek-V3 path's records and summary before the zero-compute
# experts came in: sha256 over phase, src, dst and flits (int32 bytes) and
# the sorted summary's repr.
DEEPSEEK = dict(hidden_size=256, n_routed_experts=64, num_experts_per_tok=8,
                n_group=8, topk_group=4, routed_scaling_factor=2.5,
                norm_topk_prob=True)
DEEPSEEK_DIGESTS = {
    (64, 2): (1862, "8139da8f30e3995acafc8facedea999344742797ecf0acb51d7cc6"
                    "3340d79748"),
    (256, 3): (10464, "74e534dc2100aca2099711d5010663a8d84a5f74bcac43e9a230"
                      "b1857bf6bae8"),
}


@pytest.mark.parametrize("n_pes,tokens_per_pe", sorted(DEEPSEEK_DIGESTS))
def test_the_deepseek_records_are_as_before(n_pes, tokens_per_pe):
    tr, summary = moe.moe_exchange_trace(
        DEEPSEEK, n_pes, tokens_per_pe, dispatch_bytes=7392,
        combine_bytes=14336, router_seed=3 * 256 + 7, token_seed=9,
        device="cpu", scale=231.0)
    r = tr.trace
    h = hashlib.sha256()
    for a in (r.phase, r.src, r.dst, r.flits):
        assert a.dtype == np.int32
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr(sorted(summary.items())).encode())
    assert (r.n_records, h.hexdigest()) == DEEPSEEK_DIGESTS[
        (n_pes, tokens_per_pe)]


@pytest.mark.cuda
def test_a_request_at_1024_equals_the_reference_on_the_card():
    """The cell's own request (1024 PEs, the published router, the mix's
    topic-skewed tokens) through the kernel against the reference's replay
    on the card: 0 sim, report and summary values differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the noc_step kernel has no CPU "
                    "mode")
    gen = generator.Generator(generator.load_json("configs", CELL_CONFIG),
                              generator.load_json("traffic", CELL_MIX),
                              2 ** 31 + 12345)
    req = gen.request(5)
    program.load("cuda")
    probes = tracing.Probes(program.modules(), False, torch.cuda.synchronize)
    probes.captured = cap = program.Captured()
    try:
        gen.entry.run(req, cap, "cuda", "cuda")
        torch.cuda.synchronize()
    finally:
        probes.remove()
    got = program.outputs(cap)
    want = ref.replay(req, "cuda")
    assert check.compare(got, want) == dict.fromkeys(
        ("sim_values_differing", "report_values_differing",
         "certificate_values_differing"), 0)
    sim = got["reports"][0]["sim"]
    s = got["summary"]
    assert min(sim["phase_done"]) > 0
    assert sim["delivered"] == sum(s["dispatch_flits"]) + sum(
        s["combine_flits"])
    assert sum(s["expert_tokens"]) + sum(s["identity_choices"]) == (
        1024 * req["tokens_per_pe"] * 12)
