"""FPGA resource (area) model — paper §7.1.1, Tables 2 & 3.

Table 3's percentages are analytic: component counts × per-component
resources ÷ Virtex-7 XC7VX690 capacity.  We reproduce them exactly from the
per-component numbers of Table 2 / §7.1.1 text:

  proposed mesh router          : 1358 LUT,  968 FF,  8 BRAM   (serves 16 PEs)
  four ringlets (per block)     : 1076 LUT, 1800 FF, 40 BRAM
  conventional 2D-mesh router   :  699 LUT,  572 FF,  5 BRAM   (serves 1 PE)

Checks against the paper:
  16-PE proposed-router share: 1358/433200 = 0.313%  (Table 3: 0.31) OK
  16-PE ringlet share:         1076/433200 = 0.248%  (Table 3: 0.25) OK
  16-PE conventional share: 16·699/433200  = 2.58%   (Table 3: 2.58) OK
  (Table 3's conventional-LUT entry for 32 PEs, "2.11", is inconsistent with
  its own 16->64 doubling series — 2×2.58 = 5.16 expected; we reproduce the
  analytic series and flag the paper's typo in EXPERIMENTS.md.)
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import packet as pk
from repro_torch.core import topology as topo_mod

# Xilinx Virtex-7 XC7VX690T capacity
VIRTEX7 = dict(lut=433_200, ff=866_400, bram=1_470)

PROPOSED_ROUTER = dict(lut=1358, ff=968, bram=8)
RINGLETS_PER_BLOCK_RES = dict(lut=1076, ff=1800, bram=40)  # all 4 ringlets
CONVENTIONAL_ROUTER = dict(lut=699, ff=572, bram=5)

# CONNECT NoC generator comparison (§7.1.1): our single block (16 PEs) saves
# 74.65% LUTs / 39.51% FFs vs CONNECT -> implied CONNECT 16-PE resources:
CONNECT_16PE = dict(
    lut=round((PROPOSED_ROUTER["lut"] + RINGLETS_PER_BLOCK_RES["lut"]) / (1 - 0.7465)),
    ff=round((PROPOSED_ROUTER["ff"] + RINGLETS_PER_BLOCK_RES["ff"]) / (1 - 0.3951)),
)


@dataclasses.dataclass(frozen=True)
class AreaReport:
    n_pes: int
    lut: int
    ff: int
    bram: int

    def pct(self, which: str) -> float:
        return 100.0 * getattr(self, which) / VIRTEX7[which]

    def row(self) -> dict:
        return {
            "n_pes": self.n_pes, "lut": self.lut, "ff": self.ff,
            "bram": self.bram,
            "lut_pct": round(self.pct("lut"), 2),
            "ff_pct": round(self.pct("ff"), 2),
            "bram_pct": round(self.pct("bram"), 2),
        }


def ring_mesh_router_area(n_pes: int) -> AreaReport:
    n_blocks = n_pes // pk.PES_PER_BLOCK
    return AreaReport(n_pes, n_blocks * PROPOSED_ROUTER["lut"],
                      n_blocks * PROPOSED_ROUTER["ff"],
                      n_blocks * PROPOSED_ROUTER["bram"])


def ring_mesh_ringlet_area(n_pes: int) -> AreaReport:
    n_blocks = n_pes // pk.PES_PER_BLOCK
    return AreaReport(n_pes, n_blocks * RINGLETS_PER_BLOCK_RES["lut"],
                      n_blocks * RINGLETS_PER_BLOCK_RES["ff"],
                      n_blocks * RINGLETS_PER_BLOCK_RES["bram"])


def ring_mesh_total_area(n_pes: int) -> AreaReport:
    r = ring_mesh_router_area(n_pes)
    g = ring_mesh_ringlet_area(n_pes)
    return AreaReport(n_pes, r.lut + g.lut, r.ff + g.ff, r.bram + g.bram)


def flat_mesh_area(n_pes: int) -> AreaReport:
    return AreaReport(n_pes, n_pes * CONVENTIONAL_ROUTER["lut"],
                      n_pes * CONVENTIONAL_ROUTER["ff"],
                      n_pes * CONVENTIONAL_ROUTER["bram"])


def area(topo: topo_mod.Topology) -> AreaReport:
    if topo.name.startswith("ring_mesh"):
        return ring_mesh_total_area(topo.n_pes)
    return flat_mesh_area(topo.n_pes)


def table3(sizes=(16, 32, 64, 128, 256, 512, 1024)) -> list[dict]:
    """Reproduce Table 3 (relative resource utilisation, % of Virtex-7)."""
    rows = []
    for n in sizes:
        router = ring_mesh_router_area(n)
        ringlet = ring_mesh_ringlet_area(n)
        conv = flat_mesh_area(n)
        rows.append({
            "n_pes": n,
            "proposed_router_lut_pct": round(router.pct("lut"), 2),
            "proposed_router_ff_pct": round(router.pct("ff"), 2),
            "proposed_router_bram_pct": round(router.pct("bram"), 2),
            "ring_switch_lut_pct": round(ringlet.pct("lut"), 2),
            "ring_switch_ff_pct": round(ringlet.pct("ff"), 2),
            "ring_switch_bram_pct": round(ringlet.pct("bram"), 2),
            "conventional_lut_pct": round(conv.pct("lut"), 2),
            "conventional_ff_pct": round(conv.pct("ff"), 2),
            "conventional_bram_pct": round(conv.pct("bram"), 2),
        })
    return rows


def saving_vs_conventional(n_pes: int) -> dict:
    """The paper's 'saving' convention (§7.1.1) is the difference in
    *percentage points of Virtex-7 capacity*: e.g. at 1024 PEs conventional
    LUTs are 165.23% of a device and proposed are 20.06+15.90 = 35.96%, and
    the paper reports 165.23-35.96 = 129.3% 'saving' (similarly 47.2% FF,
    139.3% BRAM; and '2% LUTs' at 16 PEs = 2.58-0.56)."""
    ours = ring_mesh_total_area(n_pes)
    conv = flat_mesh_area(n_pes)
    return {
        "n_pes": n_pes,
        "lut_saving_pct": round(conv.pct("lut") - ours.pct("lut"), 1),
        "ff_saving_pct": round(conv.pct("ff") - ours.pct("ff"), 1),
        "bram_saving_pct": round(conv.pct("bram") - ours.pct("bram"), 1),
    }
