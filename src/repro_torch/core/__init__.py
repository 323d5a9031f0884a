"""Ring-Mesh NoC core on PyTorch — the port of ``repro.core``.

Public surface:
    packet     — 43-bit single-flit codec + morph packets + escape protocol
    topology   — ring-mesh & flat-mesh link graphs + static route tables
    spec       — declarative TopologySpec (family/size/depths/morph overlays)
    traffic    — pluggable TrafficSpec registry (destination maps + locality)
    prng       — the reference's jax.random streams, on torch tensors
    sim        — cycle-level simulator (CUDA kernel or plain torch twin)
    sweep      — batched sweep engine (one kernel launch per geometry)
    experiment — Experiment/Report: declarative runs, unified JSON reports
    analytic   — diameter / bisection closed forms (§6)
    area       — FPGA resource model (Tables 2-3)
    power      — power model (Table 2, Figs 7-8)
    morph      — dynamic reconfiguration (§5)
"""
from repro_torch.core import (analytic, area, experiment, morph, packet,
                              power, prng, sim, spec, sweep, topology,
                              traffic)
from repro_torch.core.experiment import (AnalyticBounds, Budget, Experiment,
                                         Report, run_experiments)
from repro_torch.core.sim import (PAPER_LOCALITY, PATTERNS, SimConfig,
                                  SimResult, simulate)
from repro_torch.core.spec import MorphOverlay, TopologySpec
from repro_torch.core.topology import (Topology, build, build_flat_mesh,
                                       build_ring_mesh)
from repro_torch.core.traffic import TrafficSpec

__all__ = [
    "analytic", "area", "experiment", "morph", "packet", "power", "prng",
    "sim", "spec", "sweep", "topology", "traffic",
    "AnalyticBounds", "Budget", "Experiment", "Report", "run_experiments",
    "PAPER_LOCALITY", "PATTERNS", "SimConfig", "SimResult", "simulate",
    "MorphOverlay", "TopologySpec", "TrafficSpec",
    "Topology", "build", "build_flat_mesh", "build_ring_mesh",
]
