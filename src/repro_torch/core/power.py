"""Power model — paper §7.1.2 (Table 2, Figs. 7 & 8).

The paper's watt figures are FPGA (Vivado) estimates at 400 MHz.  Their
reported series is *affine in component count*: a device-level static term
(leakage of the FPGA fabric, counted once) plus a per-block (ring-mesh) or
per-router (flat mesh) dynamic term.  We calibrate by least squares to every
wattage the paper states:

ring-mesh  (blocks, W): (1, 0.89)  §7.1.2 "16x1 ... 0.89 Watt"
                        (8, 2.4)   "16x8 ... 2.4 W"
                        (16, 3.979) "1.276 W routers + 2.703 W ringlets"
                        (64, 13.59) derived: 32.8 W flat = +141.3% relative
flat mesh  (PEs, W):    (16, 0.89) "for 16 cores both consume almost the same"
                        (128, 4.5) "conventional consumes 4.5 W"
                        (1024, 32.8) "32.8 W for connecting 1024 cores"

Table-2 single-instance numbers (static/dynamic W) are kept verbatim for the
component-level report.  Dynamic power optionally scales with the simulated
activity factor (flit-hops/cycle), coupling this model to ``core.sim``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import packet as pk
from repro_torch.core import topology as topo_mod

# Table 2 (verbatim, watts)
CONV_ROUTER_STATIC = 0.323
CONV_ROUTER_DYNAMIC = 0.047
PROP_ROUTER_STATIC = 0.324
PROP_ROUTER_DYNAMIC = 0.075

_RM_POINTS = np.array([[1, 0.89], [8, 2.4], [16, 3.979], [64, 13.59]])
_FM_POINTS = np.array([[16, 0.89], [128, 4.5], [1024, 32.8]])


def _affine_fit(points: np.ndarray) -> tuple[float, float]:
    a = np.stack([np.ones(len(points)), points[:, 0]], axis=1)
    (s, d), *_ = np.linalg.lstsq(a, points[:, 1], rcond=None)
    return float(s), float(d)


RM_STATIC, RM_PER_BLOCK = _affine_fit(_RM_POINTS)
FM_STATIC, FM_PER_ROUTER = _affine_fit(_FM_POINTS)

# Split the per-block dynamic power between the modified router and the four
# ringlets using the paper's 256-core breakdown (1.276 W routers vs 2.703 W
# ringlets -> ringlets carry ~2.12x of the per-block power; at 1024 cores the
# paper quotes ~2.5x, within the fit's spread).
_ROUTER_SHARE = 1.276 / (1.276 + 2.703)
RM_PER_BLOCK_ROUTER = RM_PER_BLOCK * _ROUTER_SHARE
RM_PER_BLOCK_RINGLETS = RM_PER_BLOCK * (1 - _ROUTER_SHARE)


@dataclasses.dataclass(frozen=True)
class PowerReport:
    n_pes: int
    topology: str
    static_w: float
    dynamic_w: float
    router_w: float
    ringlet_w: float
    activity: float

    @property
    def total_w(self) -> float:
        return self.static_w + self.dynamic_w

    def row(self) -> dict:
        return {
            "topology": self.topology, "n_pes": self.n_pes,
            "static_w": round(self.static_w, 3),
            "dynamic_w": round(self.dynamic_w, 3),
            "total_w": round(self.total_w, 3),
            "router_w": round(self.router_w, 3),
            "ringlet_w": round(self.ringlet_w, 3),
            "static_pct": round(100 * self.static_w / max(self.total_w, 1e-9), 1),
        }


def ring_mesh_power(n_pes: int, activity: float = 1.0) -> PowerReport:
    """activity: dynamic scaling vs the paper's calibration workload (1.0 =
    the paper's operating point; pass measured flit-hops ratios to couple to
    the simulator)."""
    n_blocks = n_pes // pk.PES_PER_BLOCK
    dyn = n_blocks * RM_PER_BLOCK * activity
    return PowerReport(
        n_pes=n_pes, topology="ring_mesh",
        static_w=RM_STATIC, dynamic_w=dyn,
        router_w=n_blocks * RM_PER_BLOCK_ROUTER * activity,
        ringlet_w=n_blocks * RM_PER_BLOCK_RINGLETS * activity,
        activity=activity,
    )


def flat_mesh_power(n_pes: int, activity: float = 1.0) -> PowerReport:
    dyn = n_pes * FM_PER_ROUTER * activity
    return PowerReport(
        n_pes=n_pes, topology="flat_mesh",
        static_w=FM_STATIC, dynamic_w=dyn,
        router_w=dyn, ringlet_w=0.0, activity=activity,
    )


def power(topo: topo_mod.Topology, activity: float = 1.0) -> PowerReport:
    if topo.name.startswith("ring_mesh"):
        return ring_mesh_power(topo.n_pes, activity)
    return flat_mesh_power(topo.n_pes, activity)


def relative_extra_power(n_pes: int) -> float:
    """Flat-mesh power relative to ring-mesh, in % ('141.3% more at 1024')."""
    rm = ring_mesh_power(n_pes).total_w
    fm = flat_mesh_power(n_pes).total_w
    return 100.0 * (fm - rm) / rm


def activity_from_sim(flit_hops_per_cycle: float, n_pes: int,
                      calib_hops_per_pe: float = 0.9) -> float:
    """Convert a simulated activity factor into the model's dynamic scale.
    calib_hops_per_pe anchors 1.0 at the paper's operating point (locality-
    heavy traffic at the averaged Ir = 0.625)."""
    return max(flit_hops_per_cycle / (calib_hops_per_pe * n_pes), 1e-3)
