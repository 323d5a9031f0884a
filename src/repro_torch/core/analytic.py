"""Analytic NoC characterization — paper §6.

* Diameter (maximum shortest path, in network links):
      Δmax = N_R + N_C + 6                      (ring-mesh, §6.1)
  where N_R / N_C are the vertical/horizontal links of the global 2D mesh
  and 6 covers the two ringlets (2 ring hops + 1 ring<->router link each).

* Bisection bandwidth:
      β_NoC    = min(N_R, N_C) · b_l             (§6.2; cut crosses the mesh)
      β_router = b_crossbar / 2
      β_ringlet = 2 · b_l                        (bidirectional ring)

These closed forms are verified against the actual route tables / link graph
in tests (walked-hops diameter == formula; min-cut == formula).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import topology as topo_mod


def ring_mesh_diameter(n_pes: int) -> int:
    bx, by = topo_mod.RING_MESH_GRIDS[n_pes]
    n_r, n_c = by - 1, bx - 1   # links to traverse per mesh dimension
    return n_r + n_c + 6


def flat_mesh_diameter(n_pes: int) -> int:
    rx, ry = topo_mod.FLAT_MESH_GRIDS[n_pes]
    return (rx - 1) + (ry - 1)


def ring_mesh_bisection(n_pes: int, link_bw: float = 1.0) -> float:
    """min(N_R, N_C) · b_l in link-widths; N_R/N_C = rows/cols of mesh links
    crossing the cut = the smaller grid dimension (bidirectional links are
    counted once per direction pair, matching the paper's convention)."""
    bx, by = topo_mod.RING_MESH_GRIDS[n_pes]
    return min(bx, by) * link_bw


def flat_mesh_bisection(n_pes: int, link_bw: float = 1.0) -> float:
    rx, ry = topo_mod.FLAT_MESH_GRIDS[n_pes]
    return min(rx, ry) * link_bw


def router_bisection(crossbar_bw: float) -> float:
    return crossbar_bw / 2.0


def ringlet_bisection(link_bw: float = 1.0) -> float:
    return 2.0 * link_bw


def measured_diameter(topo: topo_mod.Topology, sample: int | None = None,
                      seed: int = 0) -> int:
    """Max route-table path length over (src, dst) pairs (network links only,
    excluding inject/eject buffer transfers — §6.1's counting)."""
    n = topo.n_pes
    rng = np.random.default_rng(seed)
    if sample is None or sample >= n * n:
        pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
    else:
        pairs = [(int(rng.integers(n)), int(rng.integers(n)))
                 for _ in range(sample)]
        pairs = [(s, d) for s, d in pairs if s != d]
    return max(topo.hops(s, d) for s, d in pairs)


def mesh_cut_links(topo: topo_mod.Topology) -> int:
    """Count directed MESH links crossing the midline of the global mesh in
    one direction (the minimum bisection cut of §6.2)."""
    if topo.name.startswith("ring_mesh"):
        bx, by = topo.blocks_x, topo.blocks_y
    else:
        bx, by = topo.blocks_x, topo.blocks_y
    # cut the larger dimension in half; links crossing per direction = the
    # smaller dimension's extent
    if bx >= by:
        axis_extent, cut = bx, by
    else:
        axis_extent, cut = by, bx
    mesh = (topo.link_kind == topo_mod.MESH) & (topo.link_vc == 0)
    src = topo.link_src_node[mesh]
    dst = topo.link_dst_node[mesh]
    n_pes = topo.n_pes
    if topo.name.startswith("ring_mesh"):
        src = src - n_pes
        dst = dst - n_pes
    if bx >= by:
        a, b = src % bx, dst % bx
        half = bx // 2
    else:
        a, b = src // bx, dst // bx
        half = by // 2
    crossing = ((a < half) & (b >= half))
    return int(np.sum(crossing))
