"""The report's closed-form models, frozen from the port: power (the
paper's Table 2 fits scaled by the simulated activity), FPGA area (Tables
2-3) and the analytic diameter and bisection of §6."""
from __future__ import annotations

import numpy as np

from .topology import FLAT_MESH_GRIDS, PES_PER_BLOCK, RING_MESH_GRIDS

# Table 2 (verbatim, watts) as the affine fits of the power model.
_RM_POINTS = np.array([[1, 0.89], [8, 2.4], [16, 3.979], [64, 13.59]])
_FM_POINTS = np.array([[16, 0.89], [128, 4.5], [1024, 32.8]])


def _affine_fit(points: np.ndarray) -> tuple[float, float]:
    a = np.stack([np.ones(len(points)), points[:, 0]], axis=1)
    (s, d), *_ = np.linalg.lstsq(a, points[:, 1], rcond=None)
    return float(s), float(d)


RM_STATIC, RM_PER_BLOCK = _affine_fit(_RM_POINTS)
FM_STATIC, FM_PER_ROUTER = _affine_fit(_FM_POINTS)
# The paper's 256-core split of a block's dynamic power: routers against
# ringlets.
_ROUTER_SHARE = 1.276 / (1.276 + 2.703)
RM_PER_BLOCK_ROUTER = RM_PER_BLOCK * _ROUTER_SHARE
RM_PER_BLOCK_RINGLETS = RM_PER_BLOCK * (1 - _ROUTER_SHARE)

PROPOSED_ROUTER = dict(lut=1358, ff=968, bram=8)
RINGLETS_PER_BLOCK_RES = dict(lut=1076, ff=1800, bram=40)  # all 4 ringlets
CONVENTIONAL_ROUTER = dict(lut=699, ff=572, bram=5)


def activity_from_sim(flit_hops_per_cycle: float, n_pes: int) -> float:
    """Dynamic scale of the power model: 1.0 at 0.9 flit hops per PE and
    cycle, the paper's operating point."""
    return max(flit_hops_per_cycle / (0.9 * n_pes), 1e-3)


def power(family: str, n_pes: int, activity: float) -> dict:
    if family == "ring_mesh":
        n_blocks = n_pes // PES_PER_BLOCK
        dyn = n_blocks * RM_PER_BLOCK * activity
        return dict(n_pes=n_pes, topology="ring_mesh", static_w=RM_STATIC,
                    dynamic_w=dyn,
                    router_w=n_blocks * RM_PER_BLOCK_ROUTER * activity,
                    ringlet_w=n_blocks * RM_PER_BLOCK_RINGLETS * activity,
                    activity=activity)
    dyn = n_pes * FM_PER_ROUTER * activity
    return dict(n_pes=n_pes, topology="flat_mesh", static_w=FM_STATIC,
                dynamic_w=dyn, router_w=dyn, ringlet_w=0.0,
                activity=activity)


def area(family: str, n_pes: int) -> dict:
    if family == "ring_mesh":
        n_blocks = n_pes // PES_PER_BLOCK
        per = {k: PROPOSED_ROUTER[k] + RINGLETS_PER_BLOCK_RES[k]
               for k in ("lut", "ff", "bram")}
        return dict(n_pes=n_pes, **{k: n_blocks * v for k, v in per.items()})
    return dict(n_pes=n_pes, **{k: n_pes * CONVENTIONAL_ROUTER[k]
                                for k in ("lut", "ff", "bram")})


def analytic(family: str, n_pes: int) -> dict:
    """§6's closed forms: the diameter in network links and the bisection
    in link widths."""
    if family == "ring_mesh":
        bx, by = RING_MESH_GRIDS[n_pes]
        return dict(diameter=(by - 1) + (bx - 1) + 6,
                    bisection_links=float(min(bx, by)))
    rx, ry = FLAT_MESH_GRIDS[n_pes]
    return dict(diameter=(rx - 1) + (ry - 1),
                bisection_links=float(min(rx, ry)))
