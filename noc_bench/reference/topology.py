"""The fabric builder and its static route tables, frozen from the port.

A plain copy of the ring-mesh and 2D-mesh construction (XY routing in the
global mesh, shortest-direction routing in the ringlets, the up/down VC
phases), route-walk reachability and the repair re-routing around dead
queues.  It shares no code with the program under test.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# Address geometry of a block: four ringlets of four PEs.
RINGLETS_PER_BLOCK = 4
PES_PER_RINGLET = 4
PES_PER_BLOCK = RINGLETS_PER_BLOCK * PES_PER_RINGLET

# Queue kinds
PE_SRC = 0
EJECT = 1
RING = 2
RS2R = 3
R2RS = 4
MESH = 5

KIND_NAMES = {PE_SRC: "pe_src", EJECT: "eject", RING: "ring", RS2R: "rs2r",
              R2RS: "r2rs", MESH: "mesh"}

KIND_PRIORITY = {PE_SRC: 1, EJECT: 0, RING: 3, RS2R: 3, R2RS: 2, MESH: 2}

INVALID = -1  # route table entry for dropped traffic (switched-off links)

# Mesh-size ladder used in the paper: PEs -> (blocks_x, blocks_y).
RING_MESH_GRIDS = {16: (1, 1), 32: (2, 1), 64: (2, 2), 128: (4, 2),
                   256: (4, 4), 512: (8, 4), 1024: (8, 8)}
# Flat mesh: one PE per router.
FLAT_MESH_GRIDS = {16: (4, 4), 32: (8, 4), 64: (8, 8), 128: (16, 8),
                   256: (16, 16), 512: (32, 16), 1024: (32, 32)}


@dataclasses.dataclass
class Topology:
    """Static topology + routing, consumed by ``core.sim``.

    All per-"link" arrays are per *queue* (one VC buffer of one directed
    physical channel); ``link_phys`` groups the queues that share a wire.
    """

    name: str
    n_pes: int
    blocks_x: int
    blocks_y: int
    n_links: int               # number of queues
    n_phys: int                # number of physical channels
    link_kind: np.ndarray      # int8
    link_vc: np.ndarray        # int8 (0/1; 0 for PE_SRC/EJECT)
    link_phys: np.ndarray      # int32 physical channel id
    link_src_node: np.ndarray  # int32 node id (-1 for PE_SRC virtual source)
    link_dst_node: np.ndarray  # int32 node id (-1 for EJECT sinks)
    link_prio: np.ndarray      # int32 arbitration priority
    link_cap: np.ndarray       # int32 queue capacity
    route_table: np.ndarray    # int32 [n_links, n_pes] -> next queue id
    pe_src_link: np.ndarray    # int32 [n_pes]
    pe_eject_link: np.ndarray  # int32 [n_pes]
    n_routers: int = 0
    n_ringlets: int = 0
    # Fault bookkeeping (set by TopologySpec.build_fresh for faulted
    # fabrics): dead VC queues masked out of arbitration, and the
    # post-reroute reachability matrix.
    dead_queues: np.ndarray | None = None   # bool [n_links] or None
    reachable: np.ndarray | None = None     # bool [n_pes, n_pes] or None

    @property
    def is_sink(self) -> np.ndarray:
        return self.link_kind == EJECT

    @property
    def reachable_frac(self) -> float:
        """Off-diagonal fraction of (src, dst) PE pairs with a live route
        (1.0 for healthy fabrics)."""
        if self.reachable is None:
            return 1.0
        p = self.n_pes
        if p < 2:
            return 1.0
        off = int(self.reachable.sum()) - int(np.trace(self.reachable))
        return off / (p * (p - 1))

class _Builder:
    """Accumulates queues; two VCs share one physical channel id."""

    def __init__(self):
        self.kind: list[int] = []
        self.vc: list[int] = []
        self.phys: list[int] = []
        self.src: list[int] = []
        self.dst: list[int] = []
        self.cap: list[int] = []
        self._n_phys = 0

    def add(self, kind: int, src: int, dst: int, cap: int,
            n_vcs: int = 1) -> tuple[int, ...]:
        phys = self._n_phys
        self._n_phys += 1
        ids = []
        for vc in range(n_vcs):
            self.kind.append(kind)
            self.vc.append(vc)
            self.phys.append(phys)
            self.src.append(src)
            self.dst.append(dst)
            self.cap.append(cap)
            ids.append(len(self.kind) - 1)
        return tuple(ids)


def build_ring_mesh(n_pes: int, queue_depth: int = 2,
                    src_queue_depth: int = 4) -> Topology:
    """The paper's ring-mesh: Fig. 1 instantiation for ``n_pes`` PEs."""
    if n_pes not in RING_MESH_GRIDS:
        raise ValueError(f"unsupported ring-mesh size {n_pes}")
    bx, by = RING_MESH_GRIDS[n_pes]
    n_blocks = bx * by
    n_ringlets = n_blocks * RINGLETS_PER_BLOCK
    assert n_blocks * PES_PER_BLOCK == n_pes

    def rs_node(pe: int) -> int:
        return pe

    def router_node(block: int) -> int:
        return n_pes + block

    b = _Builder()
    pe_src = np.zeros(n_pes, np.int32)
    pe_eject = np.zeros(n_pes, np.int32)
    ring_cw = np.zeros((n_pes, 2), np.int32)   # [pe, vc] CW queue leaving pe
    ring_ccw = np.zeros((n_pes, 2), np.int32)
    rs2r = np.zeros(n_ringlets, np.int32)          # up traffic: VC0 only used
    r2rs = np.zeros(n_ringlets, np.int32)          # down traffic: VC1 only
    mesh_q = {}  # (block_a, block_b) -> (vc0 id, vc1 id)

    for pe in range(n_pes):
        pe_src[pe] = b.add(PE_SRC, -1, rs_node(pe), src_queue_depth)[0]
        pe_eject[pe] = b.add(EJECT, rs_node(pe), -1, 1 << 30)[0]

    for pe in range(n_pes):
        base = pe - (pe % PES_PER_RINGLET)
        nxt = base + (pe + 1) % PES_PER_RINGLET
        prv = base + (pe - 1) % PES_PER_RINGLET
        ring_cw[pe] = b.add(RING, rs_node(pe), rs_node(nxt), queue_depth, 2)
        ring_ccw[pe] = b.add(RING, rs_node(pe), rs_node(prv), queue_depth, 2)

    for ringlet in range(n_ringlets):
        block = ringlet // RINGLETS_PER_BLOCK
        master = ringlet * PES_PER_RINGLET  # position 0 is the master RS
        # The master<->router channels carry a single phase each (up / down),
        # so one VC buffer suffices on each (the paper's dedicated inject /
        # eject buffers at the RS-router interface, Fig. 4).
        rs2r[ringlet] = b.add(RS2R, rs_node(master), router_node(block),
                              queue_depth)[0]
        r2rs[ringlet] = b.add(R2RS, router_node(block), rs_node(master),
                              queue_depth)[0]

    for y in range(by):
        for x in range(bx):
            a = y * bx + x
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                nx_, ny_ = x + dx, y + dy
                if 0 <= nx_ < bx and 0 <= ny_ < by:
                    c = ny_ * bx + nx_
                    mesh_q[(a, c)] = b.add(MESH, router_node(a),
                                           router_node(c), queue_depth, 2)

    n_links = len(b.kind)
    kind = np.array(b.kind, np.int8)

    # ---- route table (vectorized: [rows, dests] numpy, no python loops) ---
    RP = PES_PER_RINGLET
    d_pos = (np.arange(n_pes) % RP).astype(np.int32)
    d_ringlet_g = (np.arange(n_pes) // RP).astype(np.int32)
    d_block = (np.arange(n_pes) // PES_PER_BLOCK).astype(np.int32)
    d_bx = d_block % bx
    d_by = d_block // bx
    # Load-balance the two mesh VCs by destination-ringlet parity — the
    # role of the paper's "dst 00/01 -> VC-0" rule (deadlock-safe: XY).
    d_mesh_vc = d_ringlet_g % 2

    route = np.full((n_links, n_pes), INVALID, np.int32)
    dst_node = np.array(b.dst, np.int32)
    vc_arr = np.array(b.vc, np.int8)

    # Rows whose flit sits at a ring switch (phase-aware routing, §4.2).
    rs_rows = np.nonzero((dst_node >= 0) & (dst_node < n_pes))[0]
    pe_r = dst_node[rs_rows]
    vc_r = vc_arr[rs_rows].astype(np.int32)
    kind_r = kind[rs_rows].astype(np.int32)
    pos = pe_r % RP
    ringlet_r = pe_r // RP
    same = d_ringlet_g[None, :] == ringlet_r[:, None]
    dpos = np.broadcast_to(d_pos[None, :], same.shape)
    # same-ringlet: shortest direction (CW on tie, the paper's priority);
    # VC phase: down after the master RS (dateline), up for fresh traffic.
    cw = (dpos - pos[:, None]) % RP
    ccw = (pos[:, None] - dpos) % RP
    vc_out = np.where(kind_r == R2RS, 1,
                      np.where((pos == 0) & (kind_r == RING), 1,
                               np.where(kind_r == PE_SRC, 0, vc_r)))
    nxt_same = np.where(cw <= ccw,
                        ring_cw[pe_r, vc_out][:, None],
                        ring_ccw[pe_r, vc_out][:, None])
    res_same = np.where(dpos == pos[:, None],
                        pe_eject[pe_r][:, None], nxt_same)
    # other ringlet: up-phase toward the master (position 0), which hands
    # the flit to the block router.
    to_master = np.where((-pos) % RP <= pos,
                         ring_cw[pe_r, 0], ring_ccw[pe_r, 0])[:, None]
    res_rem = np.where(pos[:, None] == 0,
                       rs2r[ringlet_r][:, None], to_master)
    route[rs_rows] = np.where(same, res_same, res_rem)

    # Rows whose flit sits at a mesh router: XY dimension-order (§4.1).
    # The route depends only on (block, dest), so build one table per block
    # and assign it to every queue entering that router.
    blocks = np.arange(n_blocks, dtype=np.int32)
    mesh_next = np.full((n_blocks, 4, 2), INVALID, np.int32)  # E,W,N,S
    for (a, c), ids in mesh_q.items():
        dx, dy = c % bx - a % bx, c // bx - a // bx
        d = 0 if dx > 0 else 1 if dx < 0 else 2 if dy > 0 else 3
        mesh_next[a, d] = ids
    x, y = blocks % bx, blocks // bx
    same_b = d_block[None, :] == blocks[:, None]
    r2rs_tab = r2rs[(blocks[:, None] * RINGLETS_PER_BLOCK
                     + d_ringlet_g[None, :] % RINGLETS_PER_BLOCK)]
    dircode = np.where(x[:, None] != d_bx[None, :],
                       np.where(d_bx[None, :] > x[:, None], 0, 1),
                       np.where(d_by[None, :] > y[:, None], 2, 3))
    nxt_mesh = mesh_next[blocks[:, None], dircode,
                         np.broadcast_to(d_mesh_vc[None, :], dircode.shape)]
    router_tab = np.where(same_b, r2rs_tab, nxt_mesh)
    router_rows = np.nonzero(dst_node >= n_pes)[0]
    route[router_rows] = router_tab[dst_node[router_rows] - n_pes]

    prio = np.array([KIND_PRIORITY[int(k)] for k in kind], np.int32)
    return Topology(
        name=f"ring_mesh_{n_pes}",
        n_pes=n_pes, blocks_x=bx, blocks_y=by,
        n_links=n_links, n_phys=b._n_phys,
        link_kind=kind, link_vc=vc_arr,
        link_phys=np.array(b.phys, np.int32),
        link_src_node=np.array(b.src, np.int32),
        link_dst_node=dst_node,
        link_prio=prio,
        link_cap=np.array(b.cap, np.int32),
        route_table=route,
        pe_src_link=pe_src,
        pe_eject_link=pe_eject,
        n_routers=n_blocks,
        n_ringlets=n_ringlets,
    )


def build_flat_mesh(n_pes: int, queue_depth: int = 2,
                    src_queue_depth: int = 4) -> Topology:
    """Flattened 2D-mesh baseline: one conventional 5-port router per PE,
    two VCs per input port (Table 1), VC split by destination parity."""
    if n_pes not in FLAT_MESH_GRIDS:
        raise ValueError(f"unsupported flat-mesh size {n_pes}")
    rx, ry = FLAT_MESH_GRIDS[n_pes]
    assert rx * ry == n_pes

    b = _Builder()
    pe_src = np.zeros(n_pes, np.int32)
    pe_eject = np.zeros(n_pes, np.int32)
    for pe in range(n_pes):
        pe_src[pe] = b.add(PE_SRC, -1, pe, src_queue_depth)[0]
        pe_eject[pe] = b.add(EJECT, pe, -1, 1 << 30)[0]

    mesh_q = {}
    for y in range(ry):
        for x in range(rx):
            a = y * rx + x
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                nx_, ny_ = x + dx, y + dy
                if 0 <= nx_ < rx and 0 <= ny_ < ry:
                    c = ny_ * rx + nx_
                    mesh_q[(a, c)] = b.add(MESH, a, c, queue_depth, 2)

    n_links = len(b.kind)
    kind = np.array(b.kind, np.int8)

    # Route depends only on (router, dest): build one [routers, dests]
    # table vectorized and assign it to every queue entering each router.
    routers = np.arange(n_pes, dtype=np.int32)
    mesh_next = np.full((n_pes, 4, 2), INVALID, np.int32)  # E,W,N,S
    for (a, c), ids in mesh_q.items():
        dx, dy = c % rx - a % rx, c // rx - a // rx
        d = 0 if dx > 0 else 1 if dx < 0 else 2 if dy > 0 else 3
        mesh_next[a, d] = ids
    x, y = routers % rx, routers // rx
    dest = np.arange(n_pes, dtype=np.int32)
    tx, ty = dest % rx, dest // rx
    dircode = np.where(x[:, None] != tx[None, :],
                       np.where(tx[None, :] > x[:, None], 0, 1),
                       np.where(ty[None, :] > y[:, None], 2, 3))
    vc_sel = np.broadcast_to((dest % 2)[None, :], dircode.shape)
    router_tab = np.where(routers[:, None] == dest[None, :],
                          pe_eject[routers][:, None],
                          mesh_next[routers[:, None], dircode, vc_sel])

    route = np.full((n_links, n_pes), INVALID, np.int32)
    dst_node = np.array(b.dst, np.int32)
    rows = np.nonzero(dst_node >= 0)[0]
    route[rows] = router_tab[dst_node[rows]]

    prio = np.array([KIND_PRIORITY[int(k)] for k in kind], np.int32)
    return Topology(
        name=f"flat_mesh_{n_pes}",
        n_pes=n_pes, blocks_x=rx, blocks_y=ry,
        n_links=n_links, n_phys=b._n_phys,
        link_kind=kind,
        link_vc=np.array(b.vc, np.int8),
        link_phys=np.array(b.phys, np.int32),
        link_src_node=np.array(b.src, np.int32),
        link_dst_node=dst_node,
        link_prio=prio,
        link_cap=np.array(b.cap, np.int32),
        route_table=route,
        pe_src_link=pe_src,
        pe_eject_link=pe_eject,
        n_routers=n_pes,
        n_ringlets=0,
    )


# ---------------------------------------------------------------------------
# Fault-aware routing: route-walk classification, reachability, and
# rebuilding route tables around dead components (``faults.spec``).
# ---------------------------------------------------------------------------
_FABRIC_KINDS = (RING, RS2R, R2RS, MESH)


def _walk_classify(route: np.ndarray, is_sink: np.ndarray,
                   dead: np.ndarray | None = None) -> np.ndarray:
    """Bool [n_links, n_pes]: does a flit for dest ``d`` sitting in queue
    ``q`` reach an eject sink by following ``route``, without crossing a
    dead queue or an ``INVALID`` entry?

    Computed by pointer doubling with two absorbing states (OK / BAD):
    ``ceil(log2(n_links)) + 1`` table compositions classify every
    (queue, dest) pair at once — no per-pair walking.
    """
    l_n, p = route.shape
    a_ok, a_bad = l_n, l_n + 1
    nxt = route
    if dead is not None:
        nxt = np.where(dead[:, None], INVALID, nxt)
    tgt = np.clip(nxt, 0, l_n - 1)
    tgt_dead = dead[tgt] if dead is not None else np.zeros_like(tgt, bool)
    ptr = np.where(nxt < 0, a_bad,
                   np.where(tgt_dead, a_bad,
                            np.where(is_sink[tgt], a_ok, nxt))).astype(
        np.int32)
    ptr = np.vstack([ptr,
                     np.full((1, p), a_ok, np.int32),
                     np.full((1, p), a_bad, np.int32)])
    for _ in range(int(np.ceil(np.log2(max(l_n, 2)))) + 1):
        ptr = np.take_along_axis(ptr, ptr, axis=0)
    return ptr[:l_n] == a_ok


def reachable_pairs(topo: Topology,
                    dead: np.ndarray | None = None) -> np.ndarray:
    """Bool [n_pes, n_pes]: (src, dst) pairs with a live route under the
    optional extra dead-queue mask (on top of any faults already baked
    into ``topo.route_table``)."""
    if topo.dead_queues is not None:
        dead = (topo.dead_queues if dead is None
                else dead | topo.dead_queues)
    ok = _walk_classify(topo.route_table, topo.is_sink, dead)
    return ok[topo.pe_src_link]


def reachable_fraction(topo: Topology,
                       dead: np.ndarray | None = None) -> float:
    """Off-diagonal fraction of reachable (src, dst) pairs."""
    p = topo.n_pes
    if p < 2:
        return 1.0
    reach = reachable_pairs(topo, dead)
    off = int(reach.sum()) - int(np.trace(reach))
    return off / (p * (p - 1))


def reroute_avoiding(topo: Topology, dead: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Rebuild ``topo.route_table`` around the dead queues.

    Minimal perturbation: every (queue, dest) entry whose *entire*
    downstream path is alive is kept verbatim (healthy traffic keeps the
    paper's XY / shortest-direction routes bit-for-bit); only broken
    entries are refilled, by steering each hop onto the out-queue whose
    target node minimizes a node-level BFS distance-to-destination over
    the surviving fabric channels.  Truly disconnected entries become
    ``INVALID`` (such traffic is dropped at the point of no progress —
    the paper's switched-off-channel semantics) rather than crashing.

    Note the repair trades the dateline VC discipline for connectivity on
    the detoured pairs — graceful degradation, not a proof-preserving
    transform (DESIGN.md §13).

    Returns ``(new_route, reachable)`` with ``reachable`` the bool
    [n_pes, n_pes] pair matrix of the repaired fabric.
    """
    l_n, p = topo.n_links, topo.n_pes
    route, kind = topo.route_table, topo.link_kind
    src_n, dst_n = topo.link_src_node, topo.link_dst_node
    is_sink = topo.is_sink

    broken = ~_walk_classify(route, is_sink, dead)

    # Node-level out-queue candidates over the surviving fabric channels
    # (ascending queue id per node -> deterministic tie-breaks).
    n_nodes = int(max(src_n.max(), dst_n.max())) + 1
    live_q = np.nonzero(~dead & np.isin(kind, _FABRIC_KINDS))[0]
    deg = np.bincount(src_n[live_q], minlength=n_nodes)
    k_max = max(1, int(deg.max())) if live_q.size else 1
    cand = np.full((n_nodes, k_max), -1, np.int64)
    slot = np.zeros(n_nodes, np.int64)
    for q in live_q:
        u = src_n[q]
        cand[u, slot[u]] = q
        slot[u] += 1
    # Target node of each candidate; pads point at a sentinel INF row.
    cand_t = np.where(cand >= 0, dst_n[np.clip(cand, 0, l_n - 1)], n_nodes)

    # Bellman-Ford to fixpoint: dist[node, dest_pe].  PE node ids equal PE
    # indices in both families, so dist[d, d] = 0 seeds the recursion.
    inf = np.int32(1 << 20)
    dist = np.full((n_nodes + 1, p), inf, np.int32)
    dist[np.arange(p), np.arange(p)] = 0
    for _ in range(4 * n_nodes):
        best = dist[cand_t].min(axis=1) + 1
        new = np.minimum(dist[:n_nodes], best)
        if np.array_equal(new, dist[:n_nodes]):
            break
        dist[:n_nodes] = new

    # Best out-queue per (node, dest); unreachable -> INVALID; at the
    # destination's own node -> its eject buffer.
    sc = dist[cand_t]                      # [n_nodes, k_max, p]
    k_star = sc.argmin(axis=1)             # first minimum: lowest queue id
    best_q = cand[np.arange(n_nodes)[:, None], k_star]
    best_d = np.take_along_axis(sc, k_star[:, None, :], axis=1)[:, 0, :]
    node_route = np.where(best_d >= inf, INVALID, best_q).astype(np.int32)
    node_route[np.arange(p), np.arange(p)] = topo.pe_eject_link

    live_row = ~dead & (kind != EJECT)
    filled = node_route[np.clip(dst_n, 0, n_nodes - 1)]
    new_route = np.where(broken & live_row[:, None], filled, route)
    new_route[dead] = INVALID

    ok = _walk_classify(new_route, is_sink, dead)
    return new_route, ok[topo.pe_src_link]


def build(family: str, n_pes: int, queue_depth: int,
          src_queue_depth: int) -> Topology:
    if family == "ring_mesh":
        return build_ring_mesh(n_pes, queue_depth, src_queue_depth)
    if family == "flat_mesh":
        return build_flat_mesh(n_pes, queue_depth, src_queue_depth)
    raise ValueError(f"unknown topology family {family!r}")
