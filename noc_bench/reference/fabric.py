"""Static certification of a built fabric, frozen from the port: Dally and
Seitz deadlock freedom over the realizable channel dependencies, route
liveness, table consistency, VC discipline and queue capacity.  The two
table-wide walks run in torch on the given device, Kahn's peel on the
host.  A property is a dict: ``name``, ``ok``, ``waived``, ``data`` and
``witness``, as the program's certificate records it."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import topology as topo_mod

INVALID = topo_mod.INVALID
WITNESS_LIMIT = 8


def _prop(name: str, ok: bool, waived: bool = False,
          data: Optional[dict] = None, witness=()) -> dict:
    return {"name": name, "ok": bool(ok), "waived": waived,
            "data": dict(data or {}), "witness": list(witness)}


def _on(a, dev: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, device=dev, dtype=dtype)


def occupancy_edges(topo: topo_mod.Topology, *, device="cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(occupied [n_links, n_pes] bool, edge_src, edge_dst)`` on
    ``device``.

    ``occupied[q, d]`` is True when some flit destined to PE ``d`` can sit
    in queue ``q`` — computed by a frontier walk from every PE inject
    buffer with per-(queue, dest) dedup, so the total work is
    O(realizable pairs).  The int64 edge arrays are the sorted,
    deduplicated realizable channel-dependency edges (waiting queue ->
    next queue): sinks absorb and the inject buffers have no upstream
    waiter, matching the classic Dally-Seitz buffer-dependency
    construction.  The frontier's size is read back once per hop (about
    as many hops as the longest route).
    """
    dev = torch.device(device)
    l_n, p = topo.route_table.shape
    route = _on(topo.route_table, dev).reshape(-1)
    sink = _on(topo.is_sink, dev)
    not_src = _on(topo.link_kind != topo_mod.PE_SRC, dev)
    occ = torch.zeros(l_n * p, dtype=torch.bool, device=dev)
    q = _on(topo.pe_src_link, dev, torch.int64).repeat_interleave(p)
    d = torch.arange(p, device=dev).repeat(topo.n_pes)
    occ[q * p + d] = True
    edge_parts = []
    while q.numel():
        n = route[q * p + d].long()
        live = n >= 0
        q, d, n = q[live], d[live], n[live]
        adv = ~sink[n]
        dep = not_src[q] & adv
        edge_parts.append(torch.unique(q[dep] * (l_n + 1) + n[dep]))
        key = torch.unique(n[adv] * p + d[adv])   # in-batch dedup
        key = key[~occ[key]]                      # cross-iteration dedup
        occ[key] = True
        q, d = key // p, key % p
    e = torch.unique(torch.cat(edge_parts))
    return occ.reshape(l_n, p), e // (l_n + 1), e % (l_n + 1)


def walk_terminals(route, is_sink, dead=None, *,
                   device="cuda") -> torch.Tensor:
    """int32 [n_links, n_pes] on ``device``: where the deterministic route
    walk from (queue, dest) ends.  Values: an eject queue id (delivered
    there), ``n_links`` (severed: hit INVALID or a dead queue), or a live
    queue id (the walk never terminates — that queue lies on/enters the
    loop).

    Pointer doubling with absorbing sink/severed states classifies every
    pair in ``ceil(log2(n_links)) + 1`` table compositions
    (``torch.gather`` along dim 0).
    """
    dev = torch.device(device)
    nxt = _on(route, dev, torch.int64)
    l_n, p = nxt.shape
    bad = l_n
    if dead is not None:
        dead_t = _on(dead, dev, torch.bool)
        nxt[dead_t] = INVALID
        tgt = nxt.clamp(0, l_n - 1)
        nxt[(nxt >= 0) & dead_t[tgt]] = INVALID
    ptr = nxt.masked_fill(nxt < 0, bad)
    sink_rows = _on(np.nonzero(np.asarray(is_sink))[0], dev, torch.int64)
    ptr[sink_rows, :] = sink_rows[:, None]
    ptr = torch.cat([ptr, torch.full((1, p), bad, dtype=torch.int64,
                                     device=dev)])
    for _ in range(int(np.ceil(np.log2(max(l_n, 2)))) + 1):
        ptr = torch.gather(ptr, 0, ptr)
    return ptr[:l_n].to(torch.int32)


def _find_cycle(n_nodes: int, esrc: np.ndarray,
                edst: np.ndarray) -> Optional[list[int]]:
    """Kahn's algorithm over the dependency edges; returns one concrete
    cycle (queue ids, in route-walk order) or None when acyclic."""
    if esrc.size == 0:
        return None
    indeg = np.bincount(edst, minlength=n_nodes)
    order = np.argsort(esrc, kind="stable")
    fs, fd = esrc[order], edst[order]
    fstart = np.searchsorted(fs, np.arange(n_nodes + 1))
    stack = list(np.nonzero(indeg == 0)[0])
    indeg = indeg.copy()
    while stack:
        u = stack.pop()
        for v in fd[fstart[u]:fstart[u + 1]]:
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(int(v))
    residual = indeg > 0
    if not residual.any():
        return None
    # Every residual node has a residual predecessor: walk predecessors
    # until a repeat, then unwind into forward edge order.
    rorder = np.argsort(edst, kind="stable")
    rs, rd = esrc[rorder], edst[rorder]
    rstart = np.searchsorted(rd, np.arange(n_nodes + 1))
    u = int(np.nonzero(residual)[0][0])
    seen: dict[int, int] = {}
    path: list[int] = []
    while u not in seen:
        seen[u] = len(path)
        path.append(u)
        preds = rs[rstart[u]:rstart[u + 1]]
        u = int(preds[residual[preds]][0])
    i = seen[u]
    return [path[i]] + path[:i:-1]  # forward order: u_i -> u_m-1 -> ... u_i


def _host_edges(topo: topo_mod.Topology, device
                ) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    occ, esrc, edst = occupancy_edges(topo, device=device)
    return occ, esrc.cpu().numpy(), edst.cpu().numpy()


def extract_route_loop(topo: topo_mod.Topology, queue: int,
                       dst: int) -> list[int]:
    """The queue cycle a (queue, dst) walk falls into (``queue`` must lie
    on or lead into a loop, e.g. a ``walk_terminals`` loop value)."""
    seen: dict[int, int] = {}
    q = int(queue)
    order: list[int] = []
    while q not in seen:
        seen[q] = len(order)
        order.append(q)
        q = int(topo.route_table[q, dst])
        if q < 0 or topo.is_sink[q]:
            return []   # not actually a loop for this destination
    return order[seen[q]:]


# ---------------------------------------------------------------------------
# Property checks.
# ---------------------------------------------------------------------------
def _cycle_witness(topo: topo_mod.Topology, cycle: list[int]) -> dict:
    return {"kind": "cycle",
            "queues": [int(q) for q in cycle],
            "queue_kinds": [topo_mod.KIND_NAMES[int(topo.link_kind[q])]
                            for q in cycle]}


def _check_deadlock(topo: topo_mod.Topology, esrc: np.ndarray,
                    edst: np.ndarray) -> dict:
    cycle = _find_cycle(topo.n_links, esrc, edst)
    data = {"n_edges": int(esrc.size)}
    if cycle is None:
        return _prop("deadlock_free", True, data=data)
    return _prop("deadlock_free", False, data=data,
                 witness=(_cycle_witness(topo, cycle),))


def _check_liveness(topo: topo_mod.Topology, allow_severed: bool,
                    device="cuda") -> dict:
    l_n, p = topo.n_links, topo.n_pes
    dev = torch.device(device)
    term = walk_terminals(topo.route_table, topo.is_sink, topo.dead_queues,
                          device=dev)
    term = term[_on(topo.pe_src_link, dev, torch.int64)].cpu().numpy()
    expect = np.broadcast_to(topo.pe_eject_link[None, :], (p, p))
    delivered = term == expect
    severed = term == l_n
    sink_ext = np.concatenate([topo.is_sink, [False]])
    wrong = sink_ext[np.clip(term, 0, l_n)] & ~delivered & ~severed
    looped = ~delivered & ~severed & ~wrong

    reach = topo.reachable
    if reach is not None:
        # Repaired fabric: the walk must agree with the declared
        # reachability matrix exactly (both come from route walks, so a
        # mismatch means someone mutated the table after the repair).
        sev_bad = severed & reach
        extra = delivered & ~reach
    elif allow_severed:
        # Morph overlays switch channels off by design (§5.1 drop
        # semantics): severed pairs are legal, only loops/wrong sinks are
        # defects.
        sev_bad = np.zeros_like(severed)
        extra = np.zeros_like(severed)
    else:
        sev_bad = severed
        extra = np.zeros_like(severed)

    witness: list[dict] = []
    for s, d in zip(*np.nonzero(looped)):
        if len(witness) >= WITNESS_LIMIT:
            break
        loop = extract_route_loop(topo, term[s, d], int(d))
        witness.append({"kind": "loop", "src": int(s), "dst": int(d),
                        "queues": [int(q) for q in loop]})
    for name, mask in (("severed", sev_bad), ("wrong_sink", wrong),
                       ("undeclared_delivery", extra)):
        for s, d in zip(*np.nonzero(mask)):
            if len(witness) >= WITNESS_LIMIT:
                break
            witness.append({"kind": name, "src": int(s), "dst": int(d)})
    n_off = max(p * (p - 1), 1)
    n_delivered = int(delivered.sum())
    data = {
        "delivered": n_delivered,
        "severed": int(severed.sum()),
        "severed_violating": int(sev_bad.sum()),
        "looped": int(looped.sum()),
        "wrong_sink": int(wrong.sum()),
        "undeclared_delivery": int(extra.sum()),
        "reachable_frac": round((n_delivered - p) / n_off, 6),
        "declared_reachability": reach is not None,
    }
    ok = not (looped.any() or wrong.any() or sev_bad.any() or extra.any())
    return _prop("route_liveness", ok, data=data,
                 witness=tuple(witness))


def _check_consistency(topo: topo_mod.Topology,
                       device="cuda") -> dict:
    l_n, p = topo.n_links, topo.n_pes
    kind = topo.link_kind
    witness: list[dict] = []
    data: dict = {}

    shape_ok = topo.route_table.shape == (l_n, p)
    data["shape_ok"] = bool(shape_ok)
    if not shape_ok:
        return _prop(
            "table_consistency", False, data=data,
            witness=({"kind": "shape", "shape": list(topo.route_table.shape),
                      "expected": [l_n, p]},))

    dev = torch.device(device)
    route = _on(topo.route_table, dev, torch.int64)
    dead = _on(topo.dead_queues if topo.dead_queues is not None
               else np.zeros(l_n, bool), dev, torch.bool)

    def bad_rows(mask2d: torch.Tensor, label: str) -> int:
        n = int(mask2d.sum())
        data[label] = n
        if n:
            qd = torch.nonzero(mask2d)[:WITNESS_LIMIT]
            entries = route[qd[:, 0], qd[:, 1]]
            for (q, d), e in zip(qd.tolist(), entries.tolist()):
                if len(witness) < WITNESS_LIMIT:
                    witness.append({"kind": label, "queue": q, "dst": d,
                                    "entry": e})
        return n

    live = route >= 0
    nxt_c = route.clamp(0, l_n - 1)
    n_bad = bad_rows(route >= l_n, "out_of_range")
    n_bad += bad_rows(route < INVALID, "out_of_range_low")
    # Node-locality: every live hop leaves the queue's destination node —
    # the invariant the simulator's structural fan-in candidate tables
    # (and hence arbitration + enqueue) are built on.
    src_node = _on(topo.link_src_node, dev)
    dst_node = _on(topo.link_dst_node, dev)
    n_bad += bad_rows(live & (src_node[nxt_c] != dst_node[:, None]),
                      "non_node_local")
    n_bad += bad_rows(live & _on(kind == topo_mod.PE_SRC, dev)[nxt_c],
                      "routes_into_inject_buffer")
    n_bad += bad_rows(live & dead[nxt_c], "routes_into_dead_queue")
    n_bad += bad_rows(live & dead[:, None], "dead_queue_row_not_invalid")

    maps_ok = (
        np.all(kind[topo.pe_src_link] == topo_mod.PE_SRC)
        and np.all(kind[topo.pe_eject_link] == topo_mod.EJECT)
        and len(set(topo.pe_src_link.tolist())) == p
        and len(set(topo.pe_eject_link.tolist())) == p)
    data["pe_maps_ok"] = bool(maps_ok)
    if not maps_ok and len(witness) < WITNESS_LIMIT:
        witness.append({"kind": "pe_maps"})
    return _prop("table_consistency", n_bad == 0 and maps_ok,
                 data=data, witness=tuple(witness))


# Up/down phase order of the dateline argument (module docstring of
# core.topology): PE inject -> up (ring VC0 / RS2R) -> mesh -> down
# (R2RS / ring VC1) -> eject.  A realizable dependency edge must never
# decrease the phase.
def _phase_of(topo: topo_mod.Topology, q: np.ndarray) -> np.ndarray:
    kind = topo.link_kind[q].astype(np.int32)
    vc = topo.link_vc[q].astype(np.int32)
    phase = np.full(q.shape, 2, np.int32)            # MESH
    phase[kind == topo_mod.PE_SRC] = 0
    phase[(kind == topo_mod.RING) & (vc == 0)] = 1
    phase[kind == topo_mod.RS2R] = 1
    phase[(kind == topo_mod.RING) & (vc == 1)] = 3
    phase[kind == topo_mod.R2RS] = 3
    phase[kind == topo_mod.EJECT] = 4
    return phase


def _check_vc_discipline(topo: topo_mod.Topology, esrc: np.ndarray,
                         edst: np.ndarray, waived: bool) -> dict:
    kind = topo.link_kind
    vc = topo.link_vc
    witness: list[dict] = []
    if esrc.size == 0:
        return _prop("vc_discipline", True, waived=waived,
                     data={"violations": 0, "checked_edges": 0})
    k_s, k_d = kind[esrc], kind[edst]
    # (1) phase monotonicity over the realizable dependency edges.
    bad = _phase_of(topo, edst) < _phase_of(topo, esrc)
    # (2) mesh hops never change VC (the load-balancing split is per
    # destination, constant along a path).
    mesh = (k_s == topo_mod.MESH) & (k_d == topo_mod.MESH)
    bad |= mesh & (vc[esrc] != vc[edst])
    # (3) ring hops preserve their VC except across the master RS
    # (position 0 of the ringlet), where traffic must switch to the down
    # phase (VC1) — the dateline that breaks the ring's wraparound cycle.
    ring = (k_s == topo_mod.RING) & (k_d == topo_mod.RING)
    if topo.n_ringlets:
        inter = topo.link_dst_node[esrc]   # node the flit crosses
        at_master = ring & (inter % topo_mod.PES_PER_RINGLET == 0)
        bad |= at_master & (vc[edst] != 1)
        bad |= ring & ~at_master & (vc[esrc] != vc[edst])
    else:
        bad |= ring & (vc[esrc] != vc[edst])
    for i in np.nonzero(bad)[0][:WITNESS_LIMIT]:
        witness.append({
            "kind": "vc_violation", "queue": int(esrc[i]),
            "next": int(edst[i]),
            "edge_kinds": [topo_mod.KIND_NAMES[int(k_s[i])],
                           topo_mod.KIND_NAMES[int(k_d[i])]],
            "vcs": [int(vc[esrc[i]]), int(vc[edst[i]])]})
    return _prop("vc_discipline", not bad.any(), waived=waived,
                 data={"violations": int(bad.sum()),
                       "checked_edges": int(esrc.size)},
                 witness=tuple(witness))


def _check_capacity(topo: topo_mod.Topology, queue_depth: int,
                    src_queue_depth: int) -> dict:
    cap = topo.link_cap
    kind = topo.link_kind
    sink = kind == topo_mod.EJECT
    data: dict = {}
    bad_pos = cap < 1
    # Sinks never back-pressure: 2^29 splits finite from infinite depth.
    bad_sink = sink & (cap < (1 << 29))
    data["non_positive"] = int(bad_pos.sum())
    data["shallow_sinks"] = int(bad_sink.sum())
    wrong_fab = np.isin(kind, topo_mod._FABRIC_KINDS) & (cap != queue_depth)
    wrong_src = (kind == topo_mod.PE_SRC) & (cap != src_queue_depth)
    data["fabric_depth_mismatch"] = int(wrong_fab.sum())
    data["src_depth_mismatch"] = int(wrong_src.sum())
    bad = bad_pos | bad_sink | wrong_fab | wrong_src
    witness = [{"kind": "capacity", "queue": int(q), "cap": int(cap[q]),
                "queue_kind": topo_mod.KIND_NAMES[int(kind[q])]}
               for q in np.nonzero(bad)[0][:WITNESS_LIMIT]]
    return _prop("queue_capacity", not bad.any(), data=data,
                 witness=witness)


def certify(topo: topo_mod.Topology, queue_depth: int,
            src_queue_depth: int, device) -> dict:
    """The certificate of a fabric built without morph overlays from a
    spec with these depths.  VC discipline is required only when no fault
    is repaired into the build; severed routes must match the repaired
    fabric's declared reachability."""
    dev = torch.device(device)
    pristine = topo.dead_queues is None

    occ, esrc, edst = _host_edges(topo, dev)
    props = (
        _check_deadlock(topo, esrc, edst),
        _check_liveness(topo, False, dev),
        _check_consistency(topo, dev),
        _check_vc_discipline(topo, esrc, edst, waived=not pristine),
        _check_capacity(topo, queue_depth, src_queue_depth),
    )
    return {"topology": topo.name, "n_pes": topo.n_pes,
            "n_links": topo.n_links, "n_pairs": int(occ.sum()),
            "n_edges": int(esrc.size),
            "ok": all(p["ok"] or p["waived"] for p in props),
            "properties": list(props)}
