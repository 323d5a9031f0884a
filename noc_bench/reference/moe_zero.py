"""The plain reference of a zero-compute-expert exchange request: one
LongCat-Flash MoE layer's decode-step dispatch and combine under
topic-skewed tokens, worked out again from the published description and
replayed by the frozen cycle loop.

* The draws, each from a ``torch.Generator`` of the device: from the
  request's router seed the router weight b/256 (b uniform in [-8, 7],
  [768, hidden]), the expert bias c/2**17 (c in [-16, 15], [768]) and the
  layer's topic vectors (integers in [-8, 7], [topics, hidden]); from the
  point seed each token's 24-bit draw u, its topic the number of Zipf
  bounds floor(2**24 x the cumulative weights 1/(j+1)) that u reaches,
  then noise (integers in [-8, 8], [T, hidden]).  Hidden state =
  clamp(topic vector + noise, -8, 7) / 8.
* The router, LongCat-Flash's: float32 logits with TF32 off (exact on the
  grids), then in float64 scores = softmax over all ``n_routed_experts +
  zero_expert_num`` outputs, choice = scores + bias, the ``moe_topk``
  largest choices, ties to the lower id; weights the chosen scores times
  ``routed_scaling_factor``.  Ids from ``n_routed_experts`` on are
  identity experts: the token stays home and nothing is sent.
* The layout: ``reference/moe.py``'s placement (``n_pes /
  n_routed_experts`` domains of whole blocks), one record a (source, real
  expert) pair of n tokens x the dispatched token's flits, self excluded,
  from the rank after the source's own; combine likewise from the expert,
  n x the combined token's flits.  The summary adds each PE's identity
  choices.
* The replay: ``reference/moe.py``'s, one record a source a cycle shown to
  ``cycle.cycle_step``, stopping at the first 32-cycle mark where both
  phases are done and every queue is empty.

``precision="bfloat16"`` is the control: the logits, scores and choice
rounded to bfloat16, and the streams' draws as ``noc.draw_streams`` rounds
them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import cycle, noc
from .moe import _tables, placement, token_flits


def _ints(shape, lo: int, hi: int, gen, dev):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32)


def zipf_bounds(n_topics: int) -> torch.Tensor:
    """[n_topics - 1] int64: floor(2**24 x the cumulative Zipf weights)
    at each topic but the last."""
    run, total = [], 0.0
    for j in range(n_topics):
        total += 1.0 / (j + 1) ** 1.0
        run.append(total)
    return torch.tensor([math.floor(r / total * 2 ** 24) for r in run[:-1]],
                        dtype=torch.int64)


def logits_of(request: dict, device):
    """The request's router logits (T, E + Z) float32 and its bias."""
    m = request["model"]
    n, tpp = request["fabric"]["n_pes"], request["tokens_per_pe"]
    d = m["hidden_size"]
    n_out = m["n_routed_experts"] + m["zero_expert_num"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(request["router_seed"])
    w = _ints((n_out, d), -8, 8, gen, dev).float() / 256.0
    bias = _ints((n_out,), -16, 16, gen, dev).float() / 2.0 ** 17
    vectors = _ints((request["topics"], d), -8, 8, gen, dev)
    gen = torch.Generator(device=dev).manual_seed(request["point"]["seed"])
    u = torch.randint(0, 2 ** 24, (n * tpp,), generator=gen, device=dev,
                      dtype=torch.int64)
    bounds = zipf_bounds(request["topics"]).to(dev)
    topic = (u[:, None] >= bounds[None, :]).sum(dim=1)
    noise = _ints((n * tpp, d), -8, 9, gen, dev)
    x = torch.clamp(vectors[topic] + noise, -8, 7).float() / 8.0
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.matmul(x, w.t()), bias
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def router(logits, bias, model: dict, precision: str = "float32"):
    """The published router on logits (T, E + Z): (weights (T, k)
    float64, output ids (T, k) int64)."""
    low = (torch.float64 if precision == "float32"
           else noc.PRECISIONS[precision])

    def rounded(v):
        return v.to(low).double()
    z = rounded(logits)
    e = torch.exp(z - z.max(dim=-1, keepdim=True).values)
    scores = rounded(e / e.sum(dim=-1, keepdim=True))
    choice = rounded(scores + bias.double())
    idx = torch.sort(choice, dim=-1, descending=True,
                     stable=True)[1][:, :model["moe_topk"]]
    return scores.gather(1, idx) * model["routed_scaling_factor"], idx


def layout(request: dict, choices: torch.Tensor):
    """The two phases as per-source record lists, and the summary."""
    m, fab, dec = request["model"], request["fabric"], request["flits"]
    n, e, tpp = fab["n_pes"], m["n_routed_experts"], request["tokens_per_pe"]
    place = placement(n, e)
    dom, rank = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for d in range(place.shape[0]):
        dom[place[d]] = d
        rank[place[d]] = np.arange(e)
    ch = choices.cpu().numpy().reshape(n, tpp * choices.shape[1])
    cnt = np.zeros((n, e), np.int64)
    identity = np.zeros(n, np.int64)
    for p in range(n):
        for x in ch[p]:
            if x < e:
                cnt[p, x] += 1
            else:
                identity[p] += 1
    f_disp = token_flits(request["dispatch_bytes"], dec["flit_bytes"],
                         dec["scale"])
    f_comb = token_flits(request["combine_bytes"], dec["flit_bytes"],
                         dec["scale"])
    dispatch, combine = [[] for _ in range(n)], [[] for _ in range(n)]
    for p in range(n):
        d, r = dom[p], rank[p]
        for step in range(1, e):
            x = (r + step) % e
            if cnt[p, x]:
                dispatch[p].append((int(place[d, x]), int(cnt[p, x] * f_disp)))
            src = place[d, x]
            if cnt[src, r]:
                combine[p].append((int(src), int(cnt[src, r] * f_comb)))
    tokens = np.zeros(n, np.int64)
    for d in range(place.shape[0]):
        tokens[place[d]] = cnt[place[d]].sum(axis=0)
    summary = {
        "expert_tokens": tokens.tolist(),
        "dispatch_records": [len(x) for x in dispatch],
        "dispatch_flits": [sum(f for _, f in x) for x in dispatch],
        "combine_records": [len(x) for x in combine],
        "combine_flits": [sum(f for _, f in x) for x in combine],
        "identity_choices": identity.tolist()}
    return [dispatch, combine], summary


def simulate(request: dict, phases, device,
             precision: str = "float32") -> dict:
    """The one point's sim fields: the phases replayed one record a source
    a cycle through ``cycle.cycle_step``."""
    fab, point = request["fabric"], request["point"]
    n, cycles = fab["n_pes"], point["cycles"]
    dev = torch.device(device)
    topo = noc.build(fab)
    geom = cycle.build_geometry(topo, dev)
    inj_s, dst_s, _ = noc.draw_streams([dict(point, pattern="uniform")], n,
                                       cycles, 0, dev, precision)
    tabs = [tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                  for a in t) for t in _tables(phases, n)]
    n_ph = len(tabs)
    ph_total = torch.stack([t[2].sum() for t in tabs])[None].to(torch.int32)
    state = cycle.initial_state(1, geom.route.shape[0] - 1, geom.depth, dev,
                                n_pes=n, n_phases=n_ph)
    idx = cycle.index_tables(geom, geom.depth)
    for c in range(cycles):
        cur = min(int(state[5][0]), n_ph - 1)
        ends, dsts, _ = tabs[cur]
        sent = state[6][0]
        j = (ends <= sent[:, None]).sum(dim=1).clamp(max=ends.shape[1] - 1)
        ph_flits = torch.stack([t[2] for t in tabs])
        ph_dst = torch.zeros_like(ph_flits)
        ph_flits[cur] = ends.gather(1, j[:, None].long())[:, 0]
        ph_dst[cur] = dsts.gather(1, j[:, None].long())[:, 0]
        state, _ = cycle.cycle_step(
            geom, state, c, inj_s[:, c], dst_s[:, c], warmup=point["warmup"],
            starvation_limit=point["starvation_limit"],
            arb_iters=noc.ARB_ITERS, trace=(ph_dst[None], ph_flits[None],
                                            ph_total), idx=idx)
        if (c % 32 == 31 and bool((state[5] >= n_ph).all())
                and not bool(state[1].any())):
            break
    m = state[3][0].cpu().numpy()
    delivered = int(m[cycle.DELIVERED])
    mc = cycles - point["warmup"]
    return dict(
        topology=topo.name, n_pes=n, delivered=delivered,
        offered=int(m[cycle.OFFERED]), accepted=int(m[cycle.ACCEPTED]),
        dropped=int(m[cycle.DROPPED]), lost=int(m[cycle.LOST]),
        in_flight=int(state[1].sum()), measured_cycles=mc,
        avg_latency=int(m[cycle.LAT_SUM]) / max(delivered, 1),
        throughput=delivered / mc,
        flit_hops_per_cycle=int(m[cycle.MOVED]) / mc,
        per_pe_throughput=delivered / mc / n,
        phase_done=[int(d) for d in state[8][0].cpu().numpy()],
        reachability=topo.reachable_frac,
        stall_unretired=int(m[cycle.STALL_CREDIT]))


def replay(request: dict, device, precision: str = "float32") -> dict:
    """The request's routing summary, and its one point's report."""
    _, choices = router(*logits_of(request, device), request["model"],
                        precision)
    phases, summary = layout(request, choices)
    sim = simulate(request, phases, device, precision)
    return {"reports": [noc.report(request["fabric"], sim)],
            "summary": summary}
