"""Static fabric certification: Dally-Seitz deadlock freedom, route
liveness, and table-consistency proofs over the int32 route tables (port
of ``repro.analysis.fabric``).

The simulator trusts its route tables completely — a latent cycle in the
realizable channel-dependency graph hard-deadlocks a run under saturation,
and a severed or looping route entry silently drops or spins traffic.  The
paper argues the ring/mesh VC discipline is deadlock-free (§4.3); this
module turns that argument into a machine-checked certificate over *any*
fabric the port can build: base families, morph overlays, and
fault-repaired fabrics (``TopologySpec(faults=...)``), whose BFS-refilled
route tables are exactly the ones with no paper proof behind them.

The two table-wide walks run in torch on an explicit device (the card
unless the caller asks for the CPU); everything sequential stays on the
host in numpy:

* **Realizable occupancy** (``occupancy_edges``, on the device) — which
  (queue, dest) pairs can an actual flit ever exercise?  A frontier walk
  from every PE inject buffer advances all pairs one hop per iteration
  with (queue, dest) dedup, so the total work is O(realizable pairs).
  Dependency edges (waiting queue -> next queue) are collected during the
  walk and come back sorted and deduplicated (``torch.unique``), in the
  reference's order.
* **Deadlock freedom** (Dally & Seitz, on the host) — the realizable
  dependency graph must be acyclic.  Kahn's algorithm peels the graph; a
  non-empty residue yields a concrete queue-cycle witness (predecessor
  walk inside the residue).
* **Route liveness** — every (src, dst) route terminates, in bounded
  hops, at *dst's own* eject buffer.  A pointer-doubling walk with
  absorbing states (``walk_terminals``, on the device) classifies all
  (queue, dest) pairs at once as delivered / severed / looping; severed
  pairs must match the fabric's declared reachability matrix (repaired
  fabrics) or be explicitly allowed (morph overlays switch channels off
  by design — the paper's drop semantics).
* **Table consistency** (on the device) — route entries are in range,
  every hop is node-local (the invariant the structural fan-in candidate
  tables are built on), nothing routes into a PE inject buffer or a dead
  queue, and the PE inject/eject maps are sane.
* **VC discipline** — the dateline argument, checked edgewise: ring hops
  preserve their VC except across the master RS (where they must switch
  to the down phase), mesh hops never change VC, and the up/down phase
  order is monotone.  Repairs and morphs trade this discipline for
  connectivity by design (DESIGN.md §13), so the check is *waived* (still
  computed and reported) for non-pristine builds — acyclicity is the
  actual deadlock guarantee.
* **Queue capacity** — buffer sanity: positive finite fabric capacities,
  effectively-infinite eject sinks, spec-declared depths honoured.

Results land in a frozen, JSON-round-trippable ``FabricCertificate``
(pass/fail + witnesses per property), equal to the reference's for the
same fabric.  ``certify(spec)`` memoizes on the canonical
``TopologySpec`` hash (not on the device: a certificate does not depend
on it), so the ``Experiment(verify=True)`` / ``sweep(verify=True)``
pre-flights cost one dict hit per repeated spec.

Run the certifier over the paper's experiment grid from the CLI::

    PYTHONPATH=src python -m repro_torch.analysis.fabric      # on the card
    PYTHONPATH=src python -m repro_torch.analysis.fabric --device cpu \\
        --family ring_mesh --pes 256 --json
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import packet as pk
from repro_torch.core import topology as topo_mod
from repro_torch.core.topology import as_tensor

INVALID = topo_mod.INVALID

# Witness lists are truncated to this many entries per property: enough
# to localize the defect, small enough to keep certificates readable.
WITNESS_LIMIT = 8

PROPERTIES = ("deadlock_free", "route_liveness", "table_consistency",
              "vc_discipline", "queue_capacity")


# ---------------------------------------------------------------------------
# Certificate containers.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PropertyResult:
    """One certified property: pass/fail, JSON-able counters, and witness
    records (dicts with list/int/str values only, so ``to_json`` round
    trips exactly).  ``waived`` marks a property that was computed but is
    not *required* for this fabric (e.g. VC discipline on a repaired
    fabric, which trades the dateline for connectivity by design)."""

    name: str
    ok: bool
    waived: bool = False
    data: dict = dataclasses.field(default_factory=dict)
    witness: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "witness", tuple(self.witness))

    def to_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok, "waived": self.waived,
                "data": dict(self.data), "witness": list(self.witness)}

    @classmethod
    def from_dict(cls, d: dict) -> "PropertyResult":
        return cls(name=d["name"], ok=d["ok"], waived=d.get("waived", False),
                   data=dict(d.get("data", {})),
                   witness=tuple(d.get("witness", ())))


@dataclasses.dataclass(frozen=True)
class FabricCertificate:
    """The static verification record for one fabric build."""

    topology: str
    n_pes: int
    n_links: int
    n_pairs: int   # realizable (queue, dest) pairs the proofs cover
    n_edges: int   # realizable channel-dependency edges
    properties: tuple[PropertyResult, ...]
    spec: Optional[dict] = None   # TopologySpec.to_dict() when known
    elapsed_ms: float = 0.0

    @property
    def ok(self) -> bool:
        """True when every required property holds (waived properties are
        reported but do not gate)."""
        return all(p.ok or p.waived for p in self.properties)

    def prop(self, name: str) -> PropertyResult:
        for p in self.properties:
            if p.name == name:
                return p
        raise KeyError(f"no property {name!r} in certificate "
                       f"({[p.name for p in self.properties]})")

    def failures(self) -> list[PropertyResult]:
        return [p for p in self.properties if not (p.ok or p.waived)]

    def summary(self) -> str:
        """One line: verdict + per-property status + first witness."""
        bits = []
        for p in self.properties:
            mark = "ok" if p.ok else ("waived" if p.waived else "FAIL")
            bits.append(f"{p.name}={mark}")
        line = (f"{self.topology}: "
                f"{'CERTIFIED' if self.ok else 'REJECTED'} "
                f"[{', '.join(bits)}] "
                f"({self.n_pairs} pairs, {self.n_edges} edges, "
                f"{self.elapsed_ms:.0f} ms)")
        bad = self.failures()
        if bad and bad[0].witness:
            line += f"; witness: {bad[0].witness[0]}"
        return line

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"topology": self.topology, "n_pes": self.n_pes,
                "n_links": self.n_links, "n_pairs": self.n_pairs,
                "n_edges": self.n_edges, "ok": self.ok,
                "properties": [p.to_dict() for p in self.properties],
                "spec": self.spec, "elapsed_ms": self.elapsed_ms}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "FabricCertificate":
        return cls(topology=d["topology"], n_pes=d["n_pes"],
                   n_links=d["n_links"], n_pairs=d["n_pairs"],
                   n_edges=d["n_edges"],
                   properties=tuple(PropertyResult.from_dict(p)
                                    for p in d["properties"]),
                   spec=d.get("spec"), elapsed_ms=d.get("elapsed_ms", 0.0))

    @classmethod
    def from_json(cls, s: str) -> "FabricCertificate":
        return cls.from_dict(json.loads(s))


class CertificationError(RuntimeError):
    """A fabric failed static certification; ``certificate`` holds the
    full record, the message its one-line summary."""

    def __init__(self, certificate: FabricCertificate):
        super().__init__(certificate.summary())
        self.certificate = certificate


# ---------------------------------------------------------------------------
# Core walks (torch, on an explicit device).
# ---------------------------------------------------------------------------
def _device(device="cuda") -> torch.device:
    """The device a certification runs on.  ``"cuda"`` (the default of
    every entry point) needs a card: without one this raises rather than
    fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fabric certification on device 'cuda' needs a CUDA device and "
            "none is available; pass device='cpu' to certify on the CPU")
    return dev


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
    dev = _device(device)
    l_n, p = topo.route_table.shape
    route = as_tensor(topo.route_table, dev).reshape(-1)
    sink = as_tensor(topo.is_sink, dev)
    not_src = as_tensor(topo.link_kind != topo_mod.PE_SRC, dev)
    occ = torch.zeros(l_n * p, dtype=torch.bool, device=dev)
    q = as_tensor(topo.pe_src_link, dev, torch.int64).repeat_interleave(p)
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
    dev = _device(device)
    nxt = as_tensor(route, dev, torch.int64)
    l_n, p = nxt.shape
    bad = l_n
    if dead is not None:
        dead_t = as_tensor(dead, dev, torch.bool)
        nxt[dead_t] = INVALID
        tgt = nxt.clamp(0, l_n - 1)
        nxt[(nxt >= 0) & dead_t[tgt]] = INVALID
    ptr = nxt.masked_fill(nxt < 0, bad)
    sink_rows = as_tensor(np.nonzero(np.asarray(is_sink))[0], dev, torch.int64)
    ptr[sink_rows, :] = sink_rows[:, None]
    ptr = torch.cat([ptr, torch.full((1, p), bad, dtype=torch.int64,
                                     device=dev)])
    return topo_mod.double_pointers(ptr, l_n)[:l_n].to(torch.int32)


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


def dependency_cycle(topo: topo_mod.Topology, *,
                     device="cuda") -> Optional[list[int]]:
    """One realizable queue-dependency cycle of ``topo`` (the Dally-Seitz
    deadlock witness), or None when the fabric is deadlock-free."""
    _, esrc, edst = _host_edges(topo, device)
    return _find_cycle(topo.n_links, esrc, edst)


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
                    edst: np.ndarray) -> PropertyResult:
    cycle = _find_cycle(topo.n_links, esrc, edst)
    data = {"n_edges": int(esrc.size)}
    if cycle is None:
        return PropertyResult("deadlock_free", True, data=data)
    return PropertyResult("deadlock_free", False, data=data,
                          witness=(_cycle_witness(topo, cycle),))


def _check_liveness(topo: topo_mod.Topology, allow_severed: bool,
                    device="cuda") -> PropertyResult:
    l_n, p = topo.n_links, topo.n_pes
    dev = _device(device)
    term = walk_terminals(topo.route_table, topo.is_sink, topo.dead_queues,
                          device=dev)
    term = term[as_tensor(topo.pe_src_link, dev, torch.int64)].cpu().numpy()
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
    return PropertyResult("route_liveness", ok, data=data,
                          witness=tuple(witness))


def _check_consistency(topo: topo_mod.Topology,
                       device="cuda") -> PropertyResult:
    l_n, p = topo.n_links, topo.n_pes
    kind = topo.link_kind
    witness: list[dict] = []
    data: dict = {}

    shape_ok = topo.route_table.shape == (l_n, p)
    data["shape_ok"] = bool(shape_ok)
    if not shape_ok:
        return PropertyResult(
            "table_consistency", False, data=data,
            witness=({"kind": "shape", "shape": list(topo.route_table.shape),
                      "expected": [l_n, p]},))

    dev = _device(device)
    route = as_tensor(topo.route_table, dev, torch.int64)
    dead = as_tensor(topo.dead_queues if topo.dead_queues is not None
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
    src_node = as_tensor(topo.link_src_node, dev)
    dst_node = as_tensor(topo.link_dst_node, dev)
    n_bad += bad_rows(live & (src_node[nxt_c] != dst_node[:, None]),
                      "non_node_local")
    n_bad += bad_rows(live & as_tensor(kind == topo_mod.PE_SRC, dev)[nxt_c],
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
    return PropertyResult("table_consistency", n_bad == 0 and maps_ok,
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
                         edst: np.ndarray, waived: bool) -> PropertyResult:
    kind = topo.link_kind
    vc = topo.link_vc
    witness: list[dict] = []
    if esrc.size == 0:
        return PropertyResult("vc_discipline", True, waived=waived,
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
        at_master = ring & (inter % pk.PES_PER_RINGLET == 0)
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
    return PropertyResult("vc_discipline", not bad.any(), waived=waived,
                          data={"violations": int(bad.sum()),
                                "checked_edges": int(esrc.size)},
                          witness=tuple(witness))


def _check_capacity(topo: topo_mod.Topology,
                    spec=None) -> PropertyResult:
    cap = topo.link_cap
    kind = topo.link_kind
    sink = kind == topo_mod.EJECT
    witness: list[dict] = []
    data: dict = {}
    bad_pos = cap < 1
    # Sinks must never back-pressure (the simulator treats them as
    # infinitely deep); 2^29 is the finite/infinite split core.sim uses.
    bad_sink = sink & (cap < (1 << 29))
    data["non_positive"] = int(bad_pos.sum())
    data["shallow_sinks"] = int(bad_sink.sum())
    ok = not (bad_pos.any() or bad_sink.any())
    if spec is not None:
        fabric = np.isin(kind, topo_mod._FABRIC_KINDS)
        wrong_fab = fabric & (cap != spec.queue_depth)
        wrong_src = (kind == topo_mod.PE_SRC) & (cap != spec.src_queue_depth)
        data["fabric_depth_mismatch"] = int(wrong_fab.sum())
        data["src_depth_mismatch"] = int(wrong_src.sum())
        ok = ok and not (wrong_fab.any() or wrong_src.any())
        bad = bad_pos | bad_sink | wrong_fab | wrong_src
    else:
        bad = bad_pos | bad_sink
    for q in np.nonzero(bad)[0][:WITNESS_LIMIT]:
        witness.append({"kind": "capacity", "queue": int(q),
                        "cap": int(cap[q]),
                        "queue_kind": topo_mod.KIND_NAMES[int(kind[q])]})
    return PropertyResult("queue_capacity", ok, data=data,
                          witness=tuple(witness))


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------
def certify_topology(topo: topo_mod.Topology, *, spec=None,
                     allow_severed: Optional[bool] = None,
                     strict_vc: Optional[bool] = None,
                     device="cuda") -> FabricCertificate:
    """Certify one built ``Topology``, its walks on ``device``.

    ``spec`` (a ``core.spec.TopologySpec``) tightens the checks: severed
    routes are allowed exactly when the spec morphs channels off, VC
    discipline is required exactly when the build is pristine (no morphs,
    no repaired faults), and queue capacities are checked against the
    declared depths.  Without a spec the defaults are conservative for a
    fresh build: no severed routes, VC discipline reported but waived
    (an in-band ``MorphController`` may have rewritten the table).
    """
    t0 = time.perf_counter()
    dev = _device(device)
    if spec is not None:
        if allow_severed is None:
            allow_severed = bool(spec.morphs)
        if strict_vc is None:
            strict_vc = not spec.morphs and spec.faults is None
    else:
        if allow_severed is None:
            allow_severed = False
        if strict_vc is None:
            strict_vc = False
    occ, esrc, edst = _host_edges(topo, dev)
    props = (
        _check_deadlock(topo, esrc, edst),
        _check_liveness(topo, allow_severed, dev),
        _check_consistency(topo, dev),
        _check_vc_discipline(topo, esrc, edst, waived=not strict_vc),
        _check_capacity(topo, spec),
    )
    return FabricCertificate(
        topology=topo.name, n_pes=topo.n_pes, n_links=topo.n_links,
        n_pairs=int(occ.sum()), n_edges=int(esrc.size),
        properties=props,
        spec=spec.to_dict() if spec is not None else None,
        elapsed_ms=round((time.perf_counter() - t0) * 1e3, 3))


# Certificates memoized on the canonical spec hash (TopologySpec is
# frozen/hashable): every pre-flight over a repeated spec is a dict hit.
# The device is not part of the key: a certificate does not depend on it.
_CERT_CACHE: dict = {}


@telemetry.spanned("fabric.certify")
def certify(target, *, use_cache: bool = True,
            device="cuda") -> FabricCertificate:
    """Certify a ``TopologySpec`` (cached on the spec, which also keys the
    memoized geometry) or a bare ``Topology`` (always fresh — a mutable
    route table cannot key a cache), walking on ``device``."""
    dev = _device(device)
    if isinstance(target, topo_mod.Topology):
        return certify_topology(target, device=dev)
    from repro_torch.core.spec import TopologySpec  # local: spec imports us
    if not isinstance(target, TopologySpec):
        raise TypeError(
            f"certify() takes a TopologySpec or Topology, got "
            f"{type(target).__name__}")
    if use_cache:
        hit = _CERT_CACHE.get(target)
        if hit is not None:
            return hit
    cert = certify_topology(target.build(), spec=target, device=dev)
    if use_cache:
        if len(_CERT_CACHE) > 4096:
            _CERT_CACHE.clear()
        _CERT_CACHE[target] = cert
    return cert


def require_certified(target, **kw) -> FabricCertificate:
    """``certify`` that raises ``CertificationError`` (with the full
    certificate attached) unless every required property holds — the
    ``Experiment(verify=True)`` / ``sweep(verify=True)`` pre-flight."""
    cert = certify(target, **kw)
    if not cert.ok:
        raise CertificationError(cert)
    return cert


def certificate_cache_size() -> int:
    return len(_CERT_CACHE)


def clear_certificate_cache() -> None:
    _CERT_CACHE.clear()


# ---------------------------------------------------------------------------
# CLI: certify the paper's experiment grid.
# ---------------------------------------------------------------------------
def _config_targets(max_pes: int, with_morphs: bool, with_repairs: bool):
    """(label, spec) pairs covering the design space the reference's
    `make analyze` gates: every config-spec fabric, sampled morph
    overlays, and sampled fault-repaired fabrics."""
    from repro_torch.configs.ringmesh_noc import CONFIG
    from repro_torch.core.spec import MorphOverlay, TopologySpec
    from repro_torch.faults.spec import sample_faults

    targets = []
    for fam in ("ring_mesh", "flat_mesh"):
        for n in CONFIG.sizes:
            if n > max_pes:
                continue
            targets.append(("config", CONFIG.topology_spec(fam, n)))
    if with_morphs:
        # A router bypass and a ring switch-off: the two morph styles the
        # §5 evaluation exercises (severed routes are legal under morphs;
        # acyclicity must survive them).
        targets.append(("morph", TopologySpec(
            "ring_mesh", 64,
            morphs=(MorphOverlay(hl=1, target=1,
                                 link_states=(1, 1, 0, 0, 0, 0, 0, 0)),))))
        targets.append(("morph", TopologySpec(
            "ring_mesh", 64,
            morphs=(MorphOverlay(hl=0, target=5,
                                 link_states=(2, 0, 0, 0, 0, 0, 0, 0)),))))
    if with_repairs:
        for fam in ("ring_mesh", "flat_mesh"):
            n = min(64, max_pes)
            base = TopologySpec(fam, n)
            flt = sample_faults(base.build(), n_dead_links=4, seed=0)
            targets.append(("repair",
                            dataclasses.replace(base, faults=flt)))
    return targets


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.fabric",
        description="Statically certify NoC fabrics (deadlock freedom, "
                    "route liveness, table consistency).")
    p.add_argument("--family", default=None,
                   help="certify one family instead of the config grid")
    p.add_argument("--pes", type=int, default=64,
                   help="PE count for --family (default 64)")
    p.add_argument("--max-pes", type=int, default=1024,
                   help="cap on config-grid sizes (default 1024)")
    p.add_argument("--no-morphs", action="store_true",
                   help="skip the sampled morph overlays")
    p.add_argument("--no-repairs", action="store_true",
                   help="skip the sampled fault-repaired fabrics")
    p.add_argument("--json", action="store_true",
                   help="print full certificates as JSON")
    p.add_argument("--device", default="cuda",
                   help="where the walks run (default cuda; cpu without "
                        "a card)")
    args = p.parse_args(argv)

    if args.family is not None:
        from repro_torch.core.spec import TopologySpec
        targets = [("cli", TopologySpec(args.family, args.pes))]
    else:
        targets = _config_targets(args.max_pes, not args.no_morphs,
                                  not args.no_repairs)
    failures = 0
    for label, spec in targets:
        cert = certify(spec, use_cache=False, device=args.device)
        if args.json:
            print(cert.to_json(indent=1))
        else:
            print(f"[{label}] {cert.summary()}")
        if not cert.ok:
            failures += 1
    total = len(targets)
    print(f"# certified {total - failures}/{total} fabrics"
          + (f"; {failures} REJECTED" if failures else ""))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
