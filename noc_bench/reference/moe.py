"""The plain reference of an expert-parallel exchange request: one MoE
layer's decode-step dispatch and combine, worked out again from the
published description and replayed by the frozen cycle loop.

* The draws: hidden states a/8 (a uniform in [-8, 7]) from the point
  seed, the router weight b/256 (b in [-8, 7]) and the correction bias
  c/1024 (c in [-16, 15]) from the request's router seed, each from a
  ``torch.Generator`` of the device seeded with it, in that order.
* The router, DeepSeek-V3's (``scoring_func`` sigmoid, ``topk_method``
  noaux_tc, the published ``modeling_deepseek.py``): float32 logits with
  TF32 off, scores = sigmoid(logits), choice = scores + bias; a group's
  score the sum of its two best choices, the best ``topk_group`` groups
  kept, the best ``num_experts_per_tok`` choices of the kept groups (the
  rest masked to 0), ties to the lower id; weights the chosen scores over
  their sum (+1e-20), times ``routed_scaling_factor``.
* The layout: ``n_pes / n_routed_experts`` domains, each a rectangle of
  whole blocks of the block grid (halved along its longer side until there
  are enough), expert e of a domain on its e-th PE in row-major block
  order; each PE holds ``tokens_per_pe`` tokens and sends them to the
  experts of its own domain.  Dispatch: each (source, expert) pair with n
  tokens, self excluded, is a record of n x the dispatched token's flits,
  a source's records in rank order from the rank after its own.  Combine:
  each (expert, source) pair, n x the combined token's flits, ordered the
  same way from the expert.
* The replay: each cycle, each source's current record of the current
  phase (the first whose running end is past the flits the source has
  sent) is shown to ``cycle.cycle_step`` as a one-record phase: its end as
  the source's ``ph_flits``, its destination as ``ph_dst``; the phase
  total is the whole phase's.  It stops at the first 32-cycle mark where
  both phases are done and every queue is empty, as the replay reference
  does.

``precision="bfloat16"`` is the control: the router's logits, scores and
bias in bfloat16, and the streams' draws as ``noc.draw_streams`` rounds
them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import cycle, noc
from .topology import PES_PER_BLOCK

# The ring-mesh's block grid (blocks_x, blocks_y) by PE count (the paper's
# mesh-size ladder).
BLOCK_GRIDS = {16: (1, 1), 32: (2, 1), 64: (2, 2), 128: (4, 2),
               256: (4, 4), 512: (8, 4), 1024: (8, 8)}


def placement(n_pes: int, n_experts: int) -> np.ndarray:
    """[D, E]: the PE of expert e of domain d."""
    bx, by = BLOCK_GRIDS[n_pes]
    n_dom = n_pes // n_experts
    assert n_dom * n_experts == n_pes and n_experts % PES_PER_BLOCK == 0
    dx = dy = 1
    while dx * dy < n_dom:
        if bx // dx >= by // dy and (bx // dx) % 2 == 0:
            dx *= 2
        else:
            dy *= 2
    assert dx * dy == n_dom and bx % dx == 0 and by % dy == 0
    wx, wy = bx // dx, by // dy
    out = np.zeros((n_dom, n_experts), np.int64)
    for d in range(n_dom):
        x0, y0 = (d % dx) * wx, (d // dx) * wy
        pes = [((y0 + j // wx) * bx + x0 + j % wx) * PES_PER_BLOCK + k
               for j in range(wx * wy) for k in range(PES_PER_BLOCK)]
        out[d] = pes
    return out


def _grid(shape, lo: int, hi: int, denom: float, gen, dev):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32).float() / denom


def router(logits, bias, model: dict, precision: str = "float32"):
    """The published router on logits (T, E): (weights (T, k) float32,
    experts (T, k) int64)."""
    low = noc.PRECISIONS[precision]
    e = model["n_routed_experts"]
    g, kg, k = (model["n_group"], model["topk_group"],
                model["num_experts_per_tok"])
    scores = torch.sigmoid(logits.to(low)).float()
    choice = (scores.to(low) + bias.to(low)).float()

    def best(v, count):   # stable descending sort: ties to the lower id
        vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
        return vals[..., :count], idx[..., :count]
    group_score = best(choice.reshape(-1, g, e // g), 2)[0].sum(dim=-1)
    keep = torch.zeros_like(group_score, dtype=torch.bool)
    keep.scatter_(1, best(group_score, kg)[1], True)
    masked = choice.masked_fill(~keep.repeat_interleave(e // g, dim=1), 0.0)
    experts = best(masked, k)[1]
    weights = scores.gather(1, experts)
    if model["norm_topk_prob"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * model["routed_scaling_factor"], experts


def logits_of(request: dict, device):
    """The request's router logits (T, E) float32 and correction bias."""
    m = request["model"]
    n, tpp = request["fabric"]["n_pes"], request["tokens_per_pe"]
    d, e = m["hidden_size"], m["n_routed_experts"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(request["router_seed"])
    w = _grid((e, d), -8, 8, 256.0, gen, dev)
    bias = _grid((e,), -16, 16, 1024.0, gen, dev)
    gen = torch.Generator(device=dev).manual_seed(request["point"]["seed"])
    x = _grid((n * tpp, d), -8, 8, 8.0, gen, dev)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.matmul(x, w.t()), bias
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def token_flits(nbytes: int, flit_bytes: int, scale: float) -> int:
    """One token's flits, its bytes divided by ``scale`` first; any
    positive volume is at least one flit."""
    return max(1, math.ceil(nbytes / (flit_bytes * scale)))


def layout(request: dict, experts: torch.Tensor):
    """The two phases as per-source record lists, and the summary.

    Returns ``(phases, summary)``: ``phases[ph][src]`` the source's
    ``(dst, flits)`` records in order; ``summary`` the plain ints the
    program reports."""
    m, fab, dec = request["model"], request["fabric"], request["flits"]
    n, e, tpp = fab["n_pes"], m["n_routed_experts"], request["tokens_per_pe"]
    place = placement(n, e)
    dom, rank = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for d in range(place.shape[0]):
        dom[place[d]] = d
        rank[place[d]] = np.arange(e)
    ex = experts.cpu().numpy().reshape(n, tpp * experts.shape[1])
    cnt = np.zeros((n, e), np.int64)
    for p in range(n):
        cnt[p] = np.bincount(ex[p], minlength=e)
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
        "combine_flits": [sum(f for _, f in x) for x in combine]}
    return [dispatch, combine], summary


def _tables(phases, n: int):
    """Per phase: padded running ends and destinations [P, K] (a source's
    pads carry its total, so a source done with its records finds its
    total), and the totals [P]."""
    out = []
    for ph in phases:
        k = max(1, max(len(x) for x in ph))
        ends, dsts = np.zeros((n, k), np.int64), np.zeros((n, k), np.int64)
        for s, recs in enumerate(ph):
            run = np.cumsum([f for _, f in recs]) if recs else np.zeros(0)
            total = int(run[-1]) if len(run) else 0
            ends[s, :len(recs)] = run
            ends[s, len(recs):] = total
            dsts[s, :len(recs)] = [d for d, _ in recs]
        out.append((ends, dsts, ends[:, -1].copy()))
    return out


def replay(request: dict, device, precision: str = "float32") -> dict:
    """The request's routing summary, and its one point's report."""
    _, experts = router(*logits_of(request, device), request["model"],
                        precision)
    phases, summary = layout(request, experts)
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
        ends, dsts, totals = tabs[cur]
        sent = state[6][0]
        j = (ends <= sent[:, None]).sum(dim=1).clamp(max=ends.shape[1] - 1)
        now_flits = ends.gather(1, j[:, None].long())[:, 0]
        now_dst = dsts.gather(1, j[:, None].long())[:, 0]
        ph_flits = torch.stack([t[2] for t in tabs])
        ph_dst = torch.zeros_like(ph_flits)
        ph_flits[cur], ph_dst[cur] = now_flits, now_dst
        trace = (ph_dst[None], ph_flits[None], ph_total)
        state, _ = cycle.cycle_step(
            geom, state, c, inj_s[:, c], dst_s[:, c], warmup=point["warmup"],
            starvation_limit=point["starvation_limit"],
            arb_iters=noc.ARB_ITERS, trace=trace, idx=idx)
        if (c % 32 == 31 and bool((state[5] >= n_ph).all())
                and not bool(state[1].any())):
            break
    ql, m = state[1], state[3][0].cpu().numpy()
    delivered = int(m[cycle.DELIVERED])
    mc = cycles - point["warmup"]
    sim = dict(
        topology=topo.name, n_pes=n, delivered=delivered,
        offered=int(m[cycle.OFFERED]), accepted=int(m[cycle.ACCEPTED]),
        dropped=int(m[cycle.DROPPED]), lost=int(m[cycle.LOST]),
        in_flight=int(ql.sum()), measured_cycles=mc,
        avg_latency=int(m[cycle.LAT_SUM]) / max(delivered, 1),
        throughput=delivered / mc,
        flit_hops_per_cycle=int(m[cycle.MOVED]) / mc,
        per_pe_throughput=delivered / mc / n,
        phase_done=[int(d) for d in state[8][0].cpu().numpy()],
        reachability=topo.reachable_frac,
        stall_unretired=int(m[cycle.STALL_CREDIT]))
    return {"reports": [noc.report(fab, sim)], "summary": summary}
