"""Morphing — dynamic topology reconfiguration (paper §5, Fig. 6).

A ``MorphController`` owns the mutable link-state view of a topology.  Morph
packets (decoded by ``core.packet``) set each link of a mesh router or ring
switch to Active / Bypass / Switch-off:

* **Active**     — normal routing.
* **Bypass**     — traffic entering the channel is presented straight to the
  opposite output (east-in -> west-out), skipping the node's routing logic.
  Used for fault bypass and latency shortcuts (§5.1).
* **Switch-off** — the channel logic is disabled; traffic routed into it is
  dropped (§5.1: "Traffic entering in switched off channels is dropped").

Because routing is table-driven, applying a morph = rewriting route-table
rows; the cycle simulator is completely unchanged (INVALID entries drop).
This mirrors the hardware, where the morph FSM drives the MUX/DMUX control
lines rather than altering the pipeline.

Router link indexing for the LC field (8 x 2-bit groups, §5.1):
    0=North, 1=South, 2=East, 3=West, 4..7 = ringlets 0..3.
Ring-switch LC uses groups 0..3: 0=ring-CW, 1=ring-CCW, 2=PE, 3=router.

The RFT (Routing Flow Table, §5.1.1) — an 8x8 permit matrix carried by two
subsequent flits when PTS == 0 — is implemented as an input-port ->
output-port mask that filters a router's legal turns.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import packet as pk
from repro_torch.core import topology as topo_mod

# LC groups for a mesh router
LC_NORTH, LC_SOUTH, LC_EAST, LC_WEST = 0, 1, 2, 3
LC_RINGLET0 = 4
# LC groups for a ring switch
LC_RING_CW, LC_RING_CCW, LC_PE, LC_ROUTER = 0, 1, 2, 3


@dataclasses.dataclass
class MorphController:
    """Applies morph packets to a ring-mesh topology's route table."""

    topo: topo_mod.Topology
    link_state: np.ndarray = None  # int8 per link

    def __post_init__(self):
        if self.link_state is None:
            self.link_state = np.full(self.topo.n_links, pk.LINK_ACTIVE, np.int8)
        self._base_route = self.topo.route_table.copy()

    # -- link identification --------------------------------------------------
    def router_links(self, block: int) -> dict[int, list[int]]:
        """Map LC group -> [incoming link ids] for mesh router ``block``."""
        t = self.topo
        node = t.n_pes + block
        bx = t.blocks_x
        x, y = block % bx, block // bx
        groups: dict[int, list[int]] = {g: [] for g in range(8)}
        for l in range(t.n_links):
            if t.link_dst_node[l] != node:
                continue
            k = t.link_kind[l]
            if k == topo_mod.MESH:
                src_block = t.link_src_node[l] - t.n_pes
                sx, sy = src_block % bx, src_block // bx
                if sy < y:
                    groups[LC_NORTH].append(l)
                elif sy > y:
                    groups[LC_SOUTH].append(l)
                elif sx > x:
                    groups[LC_EAST].append(l)
                else:
                    groups[LC_WEST].append(l)
            elif k == topo_mod.RS2R:
                master = t.link_src_node[l]
                ringlet = (master // pk.PES_PER_RINGLET) % pk.RINGLETS_PER_BLOCK
                groups[LC_RINGLET0 + ringlet].append(l)
        return groups

    def ringswitch_links(self, pe: int) -> dict[int, list[int]]:
        """Map LC group -> [incoming link ids] for ring switch ``pe``."""
        t = self.topo
        groups: dict[int, list[int]] = {g: [] for g in range(4)}
        for l in range(t.n_links):
            if t.link_dst_node[l] != pe:
                continue
            k = t.link_kind[l]
            if k == topo_mod.RING:
                src = t.link_src_node[l]
                # CW link arrives from the CCW neighbour and vice versa
                base = pe - pe % pk.PES_PER_RINGLET
                if src == base + (pe - 1) % pk.PES_PER_RINGLET:
                    groups[LC_RING_CW].append(l)
                else:
                    groups[LC_RING_CCW].append(l)
            elif k == topo_mod.PE_SRC:
                groups[LC_PE].append(l)
            elif k == topo_mod.R2RS:
                groups[LC_ROUTER].append(l)
        return groups

    # -- morph application ----------------------------------------------------
    def apply(self, morph: pk.MorphPacket, target: int) -> None:
        """Apply ``morph`` to router ``target`` (hl=1) or RS ``target`` (hl=0)."""
        t = self.topo
        n_routers = t.blocks_x * t.blocks_y if morph.hl else t.n_pes
        if not 0 <= target < n_routers:
            what = "router" if morph.hl else "ring switch"
            raise ValueError(
                f"morph targets {what} {target}, but {t.name} has only "
                f"{n_routers} {what}es (0..{n_routers - 1})")
        groups = (self.router_links(target) if morph.hl
                  else self.ringswitch_links(target))
        for g, state in enumerate(morph.link_states):
            for l in groups.get(g, []):
                self.link_state[l] = state
        self._rebuild()

    def apply_payload(self, payload: int, target: int) -> None:
        self.apply(pk.decode_morph(payload), target)

    def _opposite_out(self, l: int) -> int:
        """Output queue continuing straight through ``dst_node[l]`` (same
        physical direction, same VC — the bypass wire skips routing)."""
        t = self.topo
        node = t.link_dst_node[l]
        src = t.link_src_node[l]
        vc = t.link_vc[l]
        if t.link_kind[l] == topo_mod.MESH:
            # same direction: node + (node - src)
            bx = t.blocks_x
            a, b = src - t.n_pes, node - t.n_pes
            dx, dy = b % bx - a % bx, b // bx - a // bx
            nx_, ny_ = b % bx + dx, b // bx + dy
            if 0 <= nx_ < bx and 0 <= ny_ < t.blocks_y:
                tgt_node = t.n_pes + ny_ * bx + nx_
                for m in range(t.n_links):
                    if (t.link_src_node[m] == node
                            and t.link_dst_node[m] == tgt_node
                            and t.link_kind[m] == topo_mod.MESH
                            and t.link_vc[m] == vc):
                        return m
            return topo_mod.INVALID
        if t.link_kind[l] == topo_mod.RING:
            # keep circulating in the same ring direction
            base = node - node % pk.PES_PER_RINGLET
            step = (node - src) % pk.PES_PER_RINGLET
            nxt = base + (node % pk.PES_PER_RINGLET + step) % pk.PES_PER_RINGLET
            for m in range(t.n_links):
                if (t.link_src_node[m] == node and t.link_dst_node[m] == nxt
                        and t.link_kind[m] == topo_mod.RING
                        and t.link_vc[m] == vc):
                    return m
        return topo_mod.INVALID

    def _rebuild(self) -> None:
        """Recompute the effective route table from base routes + states."""
        route = self._base_route.copy()
        off = self.link_state == pk.LINK_OFF
        bypass = self.link_state == pk.LINK_BYPASS
        # Routing into a switched-off link drops the flit.
        if off.any():
            route[np.isin(route, np.nonzero(off)[0])] = topo_mod.INVALID
        # A bypassed input channel is wired straight through its node.
        for l in np.nonzero(bypass)[0]:
            route[l, :] = self._opposite_out(int(l))
        # Traffic already inside a switched-off channel is dropped.
        route[off, :] = topo_mod.INVALID
        self.topo.route_table = route

    def reset(self) -> None:
        self.link_state[:] = pk.LINK_ACTIVE
        self.topo.route_table = self._base_route.copy()


@dataclasses.dataclass
class RoutingFlowTable:
    """§5.1.1: an 8x8 permit matrix for DL-specific custom topologies,
    carried by two 32-bit flits (64 bits total) after a PTS==0 morph."""

    bits: np.ndarray  # bool [8, 8]

    @classmethod
    def from_flits(cls, flit_a: int, flit_b: int) -> "RoutingFlowTable":
        word = (flit_a << 32) | flit_b
        bits = np.array([[(word >> (63 - (8 * i + j))) & 1 for j in range(8)]
                         for i in range(8)], dtype=bool)
        return cls(bits=bits)

    def to_flits(self) -> tuple[int, int]:
        word = 0
        for i in range(8):
            for j in range(8):
                word = (word << 1) | int(self.bits[i, j])
        return (word >> 32) & 0xFFFFFFFF, word & 0xFFFFFFFF

    def permits(self, in_port: int, out_port: int) -> bool:
        return bool(self.bits[in_port, out_port])
