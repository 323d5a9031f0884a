"""Topology construction + static route tables for the Ring-Mesh NoC.

The simulator (`core.sim`) is a *queue-level* model: every virtual channel of
every buffered port in the paper's microarchitecture is one FIFO queue.  The
paper's routers and ring switches have **two VCs per input port** (Table 1,
§4.2); we model each directed physical channel as two queue ids sharing one
``phys`` wire — arbitration grants one flit per physical channel per cycle,
while buffering and back-pressure are per (channel, VC) queue.

A flit sitting in queue ``q``'s FIFO is "in that VC buffer of node
``dst_node[q]``"; its next hop is fully precomputed into a dense
``route_table[queue, dest_pe] -> next_queue`` numpy array at build time,
because routing is static: XY dimension-order in the global mesh (§4.1) and
shortest-direction in the bidirectional ringlets (§4.2).

**VC assignment (deadlock freedom).**  The paper gives the source the VC
assignment bit (§4.3) but does not spell out a deadlock-avoidance discipline
for the ring<->mesh hierarchy; a naive assignment produces cyclic channel
dependencies (ring -> RS2R -> mesh -> R2RS -> ring) that hard-deadlock under
saturation.  We therefore use the VC bit as an up/down *phase* (the classic
dateline argument, Dally & Seitz):

  VC0 — "up" phase: PE -> ring -> master RS -> router, plus ring-local
         traffic that has not passed the master in transit;
  VC1 — "down" phase: router -> master RS -> ring -> PE, plus ring-local
         traffic after it crosses the master RS (the ringlet's dateline).

Within each VC the channel dependency graph is acyclic (ring paths never
wrap past the master inside one VC; mesh XY-DoR is acyclic), so the whole
NoC is provably deadlock-free.  On the 2D-mesh channels both VCs are used,
split by destination-ringlet parity — the load-balancing role the paper
gives its "dst 00/01 -> VC-0" rule.  This is recorded as an assumption
change in DESIGN.md §8.

Two topologies share the same mechanics:

* ``build_ring_mesh(n_pes)`` — the paper's proposal (§3, Fig. 1).
* ``build_flat_mesh(n_pes)`` — the flattened 2D-mesh baseline (§7).

Arbitration priorities (paper §4.2: in-ring traffic first; rings' traffic
processed first at the router; PE injection last):

    RING  3 | RS2R  3 | MESH  2 | R2RS  2 | PE_SRC  1 | EJECT sink
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import packet as pk

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
    # int32 [n_links, n_pes] -> next queue id.  Reassign it to change the
    # routes: core.sim.build_geometry makes the array read-only once it is
    # on a device, so an in-place write after a run raises.
    route_table: np.ndarray
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

    def unreachable_pairs(self, limit: int = 64) -> list[tuple[int, int]]:
        """Disconnected (src, dst) PE pairs of a faulted fabric, reported
        instead of crashing (empty for healthy fabrics); truncated to
        ``limit`` pairs."""
        if self.reachable is None:
            return []
        bad = ~self.reachable
        np.fill_diagonal(bad, False)
        s, d = np.nonzero(bad)
        return [(int(a), int(b)) for a, b in zip(s[:limit], d[:limit])]

    def hops(self, src: int, dst: int, max_hops: int = 10_000) -> int:
        """Network hops src->dst by walking the route table (excludes the
        inject and eject buffer transfers, matching §6.1's link counting)."""
        l = self.pe_src_link[src]
        count = -1  # first move leaves the inject buffer: not a network link
        seen: dict[int, int] = {}
        while True:
            nxt = self.route_table[l, dst]
            if nxt == INVALID:
                return -1
            count += 1
            if self.link_kind[nxt] == EJECT:
                return count
            if int(nxt) in seen or count > max_hops:
                # Report the actual queue cycle (the certifier's witness
                # format: queue ids in route-walk order), not just the pair.
                order = list(seen)
                cycle = order[seen.get(int(nxt), 0):] or order
                raise RuntimeError(
                    f"routing loop {src}->{dst}: queue cycle {cycle}")
            seen[int(nxt)] = len(seen)
            l = nxt

    def check_deadlock_free(self, *, device="cuda") -> bool:
        """Verify the *realizable* queue-dependency graph is acyclic — the
        Dally-Seitz condition.  Edges are collected by walking every
        (source, destination) route on ``device``, so only dependencies an
        actual flit can exercise are included (the full table contains
        don't-care entries for (queue, dest) pairs no flit ever occupies).

        Thin shim over ``analysis.fabric``; use ``fabric.certify``
        directly for the full property set and cycle witnesses."""
        from repro_torch.analysis import fabric
        return fabric.dependency_cycle(self, device=device) is None


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


def _ring_dir(i: int, j: int) -> int:
    """Shortest direction on a 4-node ring: +1 = CW, -1 = CCW (CW on tie,
    matching the paper's prioritised direction)."""
    cw = (j - i) % pk.PES_PER_RINGLET
    ccw = (i - j) % pk.PES_PER_RINGLET
    return 1 if cw <= ccw else -1


def build_ring_mesh(n_pes: int, queue_depth: int = 2,
                    src_queue_depth: int = 4) -> Topology:
    """The paper's ring-mesh: Fig. 1 instantiation for ``n_pes`` PEs."""
    if n_pes not in RING_MESH_GRIDS:
        raise ValueError(f"unsupported ring-mesh size {n_pes}")
    bx, by = RING_MESH_GRIDS[n_pes]
    n_blocks = bx * by
    n_ringlets = n_blocks * pk.RINGLETS_PER_BLOCK
    assert n_blocks * pk.PES_PER_BLOCK == n_pes

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
        base = pe - (pe % pk.PES_PER_RINGLET)
        nxt = base + (pe + 1) % pk.PES_PER_RINGLET
        prv = base + (pe - 1) % pk.PES_PER_RINGLET
        ring_cw[pe] = b.add(RING, rs_node(pe), rs_node(nxt), queue_depth, 2)
        ring_ccw[pe] = b.add(RING, rs_node(pe), rs_node(prv), queue_depth, 2)

    for ringlet in range(n_ringlets):
        block = ringlet // pk.RINGLETS_PER_BLOCK
        master = ringlet * pk.PES_PER_RINGLET  # position 0 is the master RS
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
    RP = pk.PES_PER_RINGLET
    d_pos = (np.arange(n_pes) % RP).astype(np.int32)
    d_ringlet_g = (np.arange(n_pes) // RP).astype(np.int32)
    d_block = (np.arange(n_pes) // pk.PES_PER_BLOCK).astype(np.int32)
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
    r2rs_tab = r2rs[(blocks[:, None] * pk.RINGLETS_PER_BLOCK
                     + d_ringlet_g[None, :] % pk.RINGLETS_PER_BLOCK)]
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


# The telemetry counter of each device's route walks, one a walk.
WALK_COUNTERS = {"cuda": "topology.walks[cuda]",
                 "cpu": "topology.walks[cpu]"}


def as_tensor(a, dev: torch.device, dtype=None) -> torch.Tensor:
    """``a`` as a tensor on ``dev`` (no copy where it is already there)."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        # A route table on a device is read-only (core.sim.build_geometry).
        # The walks only read their tables, so torch's warning that writes
        # to such a tensor are undefined does not apply.
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", "The given NumPy array is not writable")
            return torch.as_tensor(a, device=dev, dtype=dtype)
    return torch.as_tensor(a, device=dev, dtype=dtype)


def walk_doublings(l_n: int) -> int:
    """Table compositions that carry every walk of up to ``l_n`` hops to
    its end: ``ceil(log2(l_n)) + 1``."""
    return int(np.ceil(np.log2(max(l_n, 2)))) + 1


def double_pointers(ptr: torch.Tensor, l_n: int) -> torch.Tensor:
    """Pointer doubling: ``ptr`` (int64 [rows, n_pes], column ``d`` the
    next queue of a flit for dest ``d``; the rows past ``l_n`` absorbing
    states) composed with itself ``walk_doublings(l_n)`` times by
    ``torch.gather`` along dim 0, on ``ptr``'s device.  Each entry then
    holds where its walk ends: an absorbing row, or a queue on a loop."""
    for _ in range(walk_doublings(l_n)):
        ptr = torch.gather(ptr, 0, ptr)
    return ptr


@telemetry.spanned("topology.walk_classify")
def _walk_classify(route: np.ndarray, is_sink: np.ndarray,
                   dead: np.ndarray | None = None) -> np.ndarray:
    """Bool [n_links, n_pes]: does a flit for dest ``d`` sitting in queue
    ``q`` reach an eject sink by following ``route``, without crossing a
    dead queue or an ``INVALID`` entry?

    Computed by pointer doubling with two absorbing states (OK / BAD):
    ``ceil(log2(n_links)) + 1`` table compositions classify every
    (queue, dest) pair at once — no per-pair walking.  The doubling runs
    on the card when there is one, else on the CPU; the answer is the
    same on either.
    """
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    telemetry.count(WALK_COUNTERS[dev.type])
    l_n, p = route.shape
    a_ok, a_bad = l_n, l_n + 1
    nxt = as_tensor(route, dev).to(torch.int64, copy=True)
    tgt = nxt.clamp(0, l_n - 1)
    # BAD: an INVALID entry, a dead row, or a hop into a dead queue.
    bad = nxt < 0
    if dead is not None:
        dead_t = as_tensor(dead, dev)
        bad |= dead_t[:, None] | dead_t[tgt]
    # OK: a hop into a sink (unless BAD).
    nxt.masked_fill_(as_tensor(is_sink, dev)[tgt], a_ok)
    nxt.masked_fill_(bad, a_bad)
    del tgt, bad
    ptr = torch.cat([nxt, torch.tensor([[a_ok], [a_bad]], device=dev)
                     .expand(2, p)])
    del nxt
    telemetry.count("topology.walk_doublings", walk_doublings(l_n))
    return (double_pointers(ptr, l_n)[:l_n] == a_ok).cpu().numpy()


# Public name: the fabric analysis and fault repair build on this
# classification.
walk_classify = _walk_classify


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


@telemetry.spanned("topology.reachable_fraction")
def reachable_fraction(topo: Topology,
                       dead: np.ndarray | None = None) -> float:
    """Off-diagonal fraction of reachable (src, dst) pairs."""
    p = topo.n_pes
    if p < 2:
        return 1.0
    reach = reachable_pairs(topo, dead)
    off = int(reach.sum()) - int(np.trace(reach))
    return off / (p * (p - 1))


@telemetry.spanned("topology.reroute_avoiding")
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
    # A round's minimum over each node's candidates is taken one candidate
    # column at a time, in two [n_nodes, p] buffers: gathering the whole
    # [n_nodes, k_max, p] at once (53 MB at 1024 PEs) took up to twice as
    # long a round on the host of an H100 machine.
    best = np.empty((n_nodes, p), np.int32)
    col = np.empty_like(best)
    for _ in range(4 * n_nodes):
        telemetry.count("topology.bellman_ford_rounds")
        np.take(dist, cand_t[:, 0], axis=0, out=best)
        for j in range(1, k_max):
            np.take(dist, cand_t[:, j], axis=0, out=col)
            np.minimum(best, col, out=best)
        best += 1
        np.minimum(dist[:n_nodes], best, out=best)
        if np.array_equal(best, dist[:n_nodes]):
            break
        dist[:n_nodes] = best

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


@telemetry.spanned("topology.build")
def build(name: str, n_pes: int, **kw) -> Topology:
    """Deprecation shim: stringly topology construction.  New code should
    declare a ``core.spec.TopologySpec`` and call ``.build()`` — the spec
    is hashable/JSON-able and memoizes the geometry (this function always
    constructs a fresh object)."""
    if name in ("ring_mesh", "ringmesh", "proposed"):
        return build_ring_mesh(n_pes, **kw)
    if name in ("flat_mesh", "mesh", "2dmesh", "baseline"):
        return build_flat_mesh(n_pes, **kw)
    raise ValueError(f"unknown topology {name!r}")
