"""Trace front end for a mixture-of-experts layer's expert-parallel exchange:
one layer's routing in a decode step becomes a dispatch phase and a combine
phase in records form (``spec.TraceRecords``).

The deployment is DeepSeek-V3's decode (arXiv:2412.19437 §3.4): each PE
holds one routed expert and the tokens of its own data-parallel attention
rank.  The router is picked by the model's own keys: DeepSeek-V3's
group-limited sigmoid router, or, where the model has ``zero_expert_num``,
LongCat-Flash's softmax over its real and zero-compute (identity) experts.
``n_pes / n_routed_experts`` expert-parallel domains tile the ring-mesh's
block grid as rectangles of whole blocks; expert ``e`` of a domain sits on
the ``e``-th PE of the domain's blocks taken in row-major order, so each
routing group (``n_routed_experts / n_group`` consecutive experts) lies on
adjacent blocks.  A token routes to the experts of its own domain.

* Dispatch: one record for each (source PE, expert) pair that has tokens,
  ``n`` tokens x the dispatched token's flits, a source's records ordered
  from the rank after its own ((expert - source rank) mod E).
* Combine: one record for each (expert, source) pair, ``n`` x the combined
  token's flits, ordered the same way from the expert.
* A token routed to its own PE's expert sends nothing; the shared expert
  runs where the token lives and sends nothing either, and so does a
  choice of an identity expert (its token, scaled by the gate, stays
  home).

Combine waits on dispatch through the trace's phase barrier; the experts'
compute between them is not modelled.  The routing and the layout run as
tensors on the device, with no Python loop over tokens or records; the
tables come to the host once.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from repro_torch import routing, telemetry
from repro_torch.core import packet as pk
from repro_torch.core import topology as topo_mod
from repro_torch.trace.spec import (FLIT_BYTES, Trace, TraceRecords,
                                    flits_for_bytes)

# The input grids: every value is k / 2**m for a small integer k, so a
# float32 sum of ``hidden_size`` products is exact in any order and the
# logits do not depend on how the GEMM adds them up.
HIDDEN_LEVELS, HIDDEN_DENOM = (-8, 8), 8.0
WEIGHT_LEVELS, WEIGHT_DENOM = (-8, 8), 256.0
BIAS_LEVELS, BIAS_DENOM = (-16, 16), 1024.0
# LongCat-Flash's expert bias: at 1/1024 it would swamp softmax scores near
# 1/768 and decide the choice; at 2**-17 it moves choices at the margin.
ZERO_BIAS_DENOM = 2.0 ** 17
# Topic-skewed tokens: a layer's topic vectors (integers in [-8, 7]), each
# token's topic by Zipf over them from a 24-bit integer, and integer noise
# in [-8, 8] added before the hidden grid's clamp.
TOPIC_LEVELS, NOISE_LEVELS = (-8, 8), (-8, 9)
TOPIC_ZIPF, TOPIC_BITS = 1.0, 24


@functools.cache
def expert_placement(n_pes: int, n_experts: int) -> np.ndarray:
    """``pe[d, e]`` [D, E] int32: the PE holding expert ``e`` of domain
    ``d``, for ``D = n_pes / n_experts`` domains on the ring-mesh's block
    grid (``topology.RING_MESH_GRIDS``): each domain a rectangle of whole
    blocks (the grid halved along its longer side until there are D),
    domains and their blocks in row-major order."""
    if n_pes % n_experts or n_experts % pk.PES_PER_BLOCK:
        raise ValueError(f"{n_experts} experts do not tile {n_pes} PEs in "
                         f"whole blocks of {pk.PES_PER_BLOCK}")
    bx, by = topo_mod.RING_MESH_GRIDS[n_pes]
    n_dom = n_pes // n_experts
    dx = dy = 1
    while dx * dy < n_dom:
        if bx // dx >= by // dy and (bx // dx) % 2 == 0:
            dx *= 2
        elif (by // dy) % 2 == 0:
            dy *= 2
        else:
            raise ValueError(f"{n_dom} domains do not tile a {bx} x {by} "
                             "block grid")
    if dx * dy != n_dom:
        raise ValueError(f"{n_dom} domains do not tile a {bx} x {by} block "
                         "grid")
    wx, wy = bx // dx, by // dy
    d = np.arange(n_dom)[:, None]
    blk = np.arange(wx * wy)[None, :]
    block = ((d // dx) * wy + blk // wx) * bx + (d % dx) * wx + blk % wx
    pe = block[:, :, None] * pk.PES_PER_BLOCK + np.arange(pk.PES_PER_BLOCK)
    return pe.reshape(n_dom, n_experts).astype(np.int32)


@contextlib.contextmanager
def _float32_matmul():
    """float32 GEMMs without TF32 for the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _grid(shape, levels, denom, gen, device) -> torch.Tensor:
    return torch.randint(*levels, shape, generator=gen, device=device,
                         dtype=torch.int32).float() / denom


def draw_router(hidden_size: int, n_out: int, seed: int, device, *,
                bias_denom: float = BIAS_DENOM, topics: int | None = None):
    """The router's weight (E, hidden) and bias (E,) of one layer, and its
    ``topics`` topic vectors (topics, hidden) int32 (None without), from
    ``seed`` on ``device``'s generator, in that order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    weight = _grid((n_out, hidden_size), WEIGHT_LEVELS, WEIGHT_DENOM, gen,
                   device)
    bias = _grid((n_out,), BIAS_LEVELS, bias_denom, gen, device)
    vectors = None if topics is None else torch.randint(
        *TOPIC_LEVELS, (topics, hidden_size), generator=gen, device=device,
        dtype=torch.int32)
    return weight, bias, vectors


def topic_bounds(n_topics: int) -> np.ndarray:
    """[n_topics - 1] int64: a token whose 24-bit draw ``u`` passes ``j``
    of these takes topic ``j`` (Zipf with exponent ``TOPIC_ZIPF``):
    floor(2**24 x the cumulative weights), so the draw is exact on any
    device."""
    w = 1.0 / np.arange(1, n_topics + 1, dtype=np.float64) ** TOPIC_ZIPF
    c = np.cumsum(w)
    return np.floor(c[:-1] / c[-1] * 2 ** TOPIC_BITS).astype(np.int64)


def draw_hidden(tokens: int, hidden_size: int, seed: int, device,
                topics: torch.Tensor | None = None):
    """The layer's input hidden states (tokens, hidden), from ``seed``:
    iid on the grid, or with ``topics`` (topics, hidden) each token's
    topic (Zipf) and then integer noise, clamped to the grid."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if topics is None:
        return _grid((tokens, hidden_size), HIDDEN_LEVELS, HIDDEN_DENOM, gen,
                     device)
    u = torch.randint(0, 2 ** TOPIC_BITS, (tokens,), generator=gen,
                      device=device, dtype=torch.int64)
    bounds = torch.as_tensor(topic_bounds(topics.shape[0]), device=device)
    topic = torch.searchsorted(bounds, u, right=True)
    noise = torch.randint(*NOISE_LEVELS, (tokens, hidden_size),
                          generator=gen, device=device, dtype=torch.int32)
    lo, hi = HIDDEN_LEVELS
    return (topics[topic] + noise).clamp_(lo, hi - 1).float() / HIDDEN_DENOM


def route(model: dict, n_pes: int, tokens_per_pe: int, *, router_seed: int,
          token_seed: int, device, topics: int | None = None):
    """One MoE layer's routing of ``n_pes * tokens_per_pe`` fresh tokens:
    ``(weights, experts)`` (T, k), token ``t`` on PE ``t // tokens_per_pe``.
    ``model`` holds the published router keys: DeepSeek-V3's
    (``hidden_size``, ``n_routed_experts``, ``num_experts_per_tok``,
    ``n_group``, ``topk_group``, ``routed_scaling_factor``,
    ``norm_topk_prob``) or LongCat-Flash's (``hidden_size``,
    ``n_routed_experts``, ``zero_expert_num``, ``moe_topk``,
    ``routed_scaling_factor``), whose ids from ``n_routed_experts`` on are
    identity experts.  ``topics`` draws the tokens around that many topic
    vectors a layer (None: iid).  While telemetry is on, the ``moe.draw``
    span holds the hidden states' draw, closed after a device
    synchronise."""
    d, e = model["hidden_size"], model["n_routed_experts"]
    zero = "zero_expert_num" in model
    if zero and model.get("zero_expert_type", "identity") != "identity":
        raise ValueError("only identity zero-compute experts are modelled, "
                         f"not {model['zero_expert_type']!r}")
    n_out = e + model["zero_expert_num"] if zero else e
    with _float32_matmul():
        weight, bias, vectors = draw_router(
            d, n_out, router_seed, device,
            bias_denom=ZERO_BIAS_DENOM if zero else BIAS_DENOM,
            topics=topics)
        with telemetry.span("moe.draw"):
            x = draw_hidden(n_pes * tokens_per_pe, d, token_seed, device,
                            vectors)
            if telemetry.is_on() and x.is_cuda:
                torch.cuda.synchronize(x.device)
        logits = x @ weight.T
    if zero:
        return routing.softmax_top_k(logits, bias, k=model["moe_topk"],
                                     scaling=model["routed_scaling_factor"])
    return routing.group_limited_top_k(
        logits, bias, n_group=model["n_group"],
        topk_group=model["topk_group"], k=model["num_experts_per_tok"],
        scaling=model["routed_scaling_factor"],
        norm=model["norm_topk_prob"])


def exchange_records(experts: torch.Tensor, n_pes: int, n_experts: int,
                     tokens_per_pe: int, dispatch_flits: int,
                     combine_flits: int, identity: bool = False):
    """The dispatch and combine records of one routing, on its device:
    ``(phase, src, dst, flits)`` int32 [R] in (phase, source) order, each
    source's records in injection order, and the summary's tensors:
    ``expert_tokens`` [P] (tokens routed to the expert on each PE, its own
    PE's included) and the per-PE record counts and flits of each phase.
    A choice of an id from ``n_experts`` on is an identity expert's: it
    leads to no PE and makes no record; with ``identity`` the summary also
    holds ``identity_choices`` [P], each PE's such choices."""
    dev = experts.device
    place = torch.as_tensor(expert_placement(n_pes, n_experts), device=dev)
    n_dom = place.shape[0]
    dom = torch.empty(n_pes, dtype=torch.int64, device=dev)
    rank = torch.empty(n_pes, dtype=torch.int64, device=dev)
    flat = place.reshape(-1).long()
    dom[flat] = torch.arange(n_dom, device=dev).repeat_interleave(n_experts)
    rank[flat] = torch.arange(n_experts, device=dev).repeat(n_dom)
    src_pe = torch.arange(n_pes, device=dev).repeat_interleave(
        tokens_per_pe * experts.shape[1])
    # cnt[p, e]: tokens of PE p routed to expert e of p's domain; identity
    # choices fall in one bin past the last, dropped.
    ex = experts.reshape(-1).long()
    slot = torch.where(ex < n_experts, src_pe * n_experts + ex,
                       n_pes * n_experts)
    cnt = torch.bincount(slot, minlength=n_pes * n_experts + 1)[:-1].view(
        n_pes, n_experts)
    step = torch.arange(1, n_experts, device=dev)
    ahead = (rank[:, None] + step) % n_experts               # [P, E-1]
    peer = place.long()[dom[:, None], ahead]                  # [P, E-1]
    # Dispatch: PE p to the expert `ahead` ranks on; combine: the expert
    # on PE q back to the source `ahead` ranks on, whose count of q's
    # expert is cnt[peer, rank[q]].
    n_disp = cnt.gather(1, ahead)
    n_comb = cnt[peer, rank[:, None].expand_as(peer)]
    src = torch.arange(n_pes, device=dev)[:, None].expand_as(peer)
    cols = []
    for ph, n, fl in ((0, n_disp, dispatch_flits), (1, n_comb,
                                                     combine_flits)):
        keep = n > 0
        cols.append(torch.stack([
            torch.full_like(n[keep], ph), src[keep], peer[keep],
            n[keep] * fl]))
    phase, s, dd, f = torch.cat(cols, dim=1).to(torch.int32)
    # Each expert's tokens: its domain's sources' counts, summed.
    on_dom = torch.zeros((n_dom, n_experts), dtype=torch.int64, device=dev)
    on_dom.index_add_(0, dom, cnt)
    on_pe = torch.zeros(n_pes, dtype=torch.int64, device=dev)
    on_pe[flat] = on_dom.reshape(-1)
    summary = dict(
        expert_tokens=on_pe,
        dispatch_records=(n_disp > 0).sum(dim=1),
        dispatch_flits=n_disp.sum(dim=1) * dispatch_flits,
        combine_records=(n_comb > 0).sum(dim=1),
        combine_flits=n_comb.sum(dim=1) * combine_flits)
    if identity:
        summary["identity_choices"] = (tokens_per_pe * experts.shape[1]
                                       - cnt.sum(dim=1))
    return (phase, s, dd, f), summary


def moe_exchange_trace(model: dict, n_pes: int, tokens_per_pe: int, *,
                       dispatch_bytes: int, combine_bytes: int,
                       router_seed: int, token_seed: int, device,
                       flit_bytes: int = FLIT_BYTES, scale: float = 1.0,
                       label: str = "", topics: int | None = None
                       ) -> tuple[Trace, dict]:
    """One MoE layer's decode-step exchange as a two-phase ``Trace`` on
    ``n_pes`` PEs, one routed expert a PE, and its routing summary.

    ``model`` holds the published router keys (see ``route``); the router
    weights (and with ``topics`` the layer's topic vectors) come from
    ``router_seed`` and the tokens' hidden states from ``token_seed``, all
    drawn on ``device``, where the logits are float32 GEMMs without TF32.
    A dispatched token of ``dispatch_bytes`` and a combined one of
    ``combine_bytes`` become flits at ``flit_bytes`` a flit, the byte
    volume divided by ``scale`` first (recorded on the trace).  The
    summary holds plain ints: ``expert_tokens`` [n_pes] and each PE's
    ``dispatch_records``, ``dispatch_flits``, ``combine_records`` and
    ``combine_flits`` [n_pes], and for a model with identity experts each
    PE's ``identity_choices``.

    While telemetry is on, the ``moe.route`` span (the draws, the GEMM and
    the top-k) closes after a device synchronise, so it holds their device
    time, and ``moe.draw`` inside it the hidden states' draw;
    ``trace.build`` holds the layout and the tables' copy to the host.
    The counter ``moe.expert_tokens_max`` holds the largest expert's
    tokens over the calls since the last drain; ``moe.choices[routed]``
    and ``moe.choices[identity]`` count the choices of real and identity
    experts."""
    e = model["n_routed_experts"]
    with telemetry.span("moe.route"):
        _, experts = route(model, n_pes, tokens_per_pe,
                           router_seed=router_seed, token_seed=token_seed,
                           device=device, topics=topics)
        if telemetry.is_on() and experts.is_cuda:
            # The span holds the router's device time, not only its launches.
            torch.cuda.synchronize(experts.device)
    with telemetry.span("trace.build"):
        cols, summary = exchange_records(
            experts, n_pes, e, tokens_per_pe,
            flits_for_bytes(dispatch_bytes, flit_bytes, scale),
            flits_for_bytes(combine_bytes, flit_bytes, scale),
            identity="zero_expert_num" in model)
        n_cols = len(cols)
        host = torch.cat([c.long() for c in (*cols, *summary.values())]
                         ).cpu().numpy()
        r = cols[0].shape[0]
        phase, src, dst, flits = host[:n_cols * r].reshape(n_cols, r)
        out = host[n_cols * r:].reshape(len(summary), n_pes)
        spec = TraceRecords(n_pes=n_pes, n_phases=2, phase=phase, src=src,
                            dst=dst, flits=flits, flit_bytes=flit_bytes,
                            scale=scale, label=label)
        summary = {k: out[i].tolist() for i, k in enumerate(summary)}
    n_disp = int(np.count_nonzero(phase == 0))
    telemetry.count("moe.tokens", n_pes * tokens_per_pe)
    telemetry.count("moe.records[dispatch]", n_disp)
    telemetry.count("moe.records[combine]", r - n_disp)
    routed = sum(summary["expert_tokens"])
    telemetry.count("moe.choices[routed]", routed)
    telemetry.count("moe.choices[identity]",
                    n_pes * tokens_per_pe * experts.shape[1] - routed)
    # A running maximum since the last drain, on the summing counter.
    most = max(summary["expert_tokens"])
    telemetry.count("moe.expert_tokens_max", max(
        0, most - telemetry.counter("moe.expert_tokens_max")))
    return Trace(trace=spec), summary
