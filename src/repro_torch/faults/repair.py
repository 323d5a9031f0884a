"""Repair morphs: the paper's §5.1 fault-bypass claim, quantified.

§5.1 argues a faulty component is survivable because the fabric can be
*re-morphed* around it — bypass/switch-off link states reshape the route
structure so traffic detours the fault.  Here the repair morph is
realized at its natural generality: ``TopologySpec.faults`` rebuilds the
route tables around every dead component at build time
(``topology.reroute_avoiding`` — keep intact routes, BFS-refill broken
ones over the surviving fabric), which subsumes the 8 x 2-bit per-switch
states of the wire protocol.

``suggest_repair_morph(spec, faults)`` returns the repaired spec;
``measure_repair(...)`` runs the healthy / faulted-unrepaired / repaired
triplet through ``run_experiments`` and reports delivered fraction,
reachability and latency inflation side by side — degradation *with* the
repair morph against degradation *without* it — with a static
certificate of the repaired fabric.

Transient faults (probabilistic flit drops) are behaviour, not
structure: a repair morph cannot route around a link that is merely
lossy, so transient entries stay runtime-injected on every leg of the
comparison and only dead components are repaired into the fabric.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch import telemetry
from repro_torch.faults.spec import FaultSpec

# core.experiment imports core.spec, which imports faults.spec — this
# module sits below faults/__init__'s lazy boundary, so the eager import
# here is safe (and required: measure_repair runs Experiments).
from repro_torch.core import experiment as exp_mod
from repro_torch.core.spec import TopologySpec


def merge_faults(a: Optional[FaultSpec],
                 b: Optional[FaultSpec]) -> Optional[FaultSpec]:
    """Union of two fault scenarios (ids deduplicated; transient entries
    concatenated, first occurrence of an exact duplicate kept)."""
    if not a:
        return b or None
    if not b:
        return a
    return FaultSpec(
        dead_links=tuple(sorted(set(a.dead_links) | set(b.dead_links))),
        dead_routers=tuple(sorted(set(a.dead_routers)
                                  | set(b.dead_routers))),
        transient=a.transient + tuple(t for t in b.transient
                                      if t not in a.transient))


def split_faults(f: FaultSpec) -> tuple[Optional[FaultSpec],
                                        Optional[FaultSpec]]:
    """(structural, transient) halves of a scenario: dead components are
    repairable by re-routing; lossy links are not."""
    dead = (FaultSpec(dead_links=f.dead_links, dead_routers=f.dead_routers)
            if f.dead_links or f.dead_routers else None)
    trans = FaultSpec(transient=f.transient) if f.transient else None
    return dead, trans


def healthy_twin(spec: TopologySpec) -> TopologySpec:
    """The same fabric with no faults repaired in — the baseline of every
    degradation comparison."""
    return dataclasses.replace(spec, faults=None)


@telemetry.spanned("repair.suggest_repair_morph")
def suggest_repair_morph(spec: TopologySpec,
                         faults: Optional[FaultSpec] = None) -> TopologySpec:
    """The repaired spec: ``faults``' dead components (merged with any the
    spec already repairs) baked into the build, so route tables detour
    them (§5.1 fault bypass).  Raises ValueError if an id is out of range
    for the spec's topology.  Transient entries are dropped — they are
    not repairable by morphing; keep them on the Experiment instead."""
    dead, _ = split_faults(merge_faults(spec.faults, faults)
                           or FaultSpec())
    return dataclasses.replace(spec, faults=dead)


@telemetry.spanned("repair.measure_repair")
def measure_repair(spec: TopologySpec, faults: FaultSpec, *,
                   traffic="uniform", inj_rate: float = 0.25,
                   budget: Optional[exp_mod.Budget] = None,
                   seed: int = 0) -> dict:
    """Quantify the §5.1 claim for one scenario: run healthy /
    faulted-unrepaired / repaired through ``run_experiments`` and join
    the resilience columns.  ``repair_gain`` is the delivered-fraction
    improvement the repair morph buys over living with the faults.  The
    legs and the certificate run on the budget's device (the card unless
    it says ``device="cpu"``)."""
    if not isinstance(faults, FaultSpec):
        raise TypeError("faults must be a FaultSpec")
    budget = budget or exp_mod.Budget()
    base = healthy_twin(spec)
    dead, trans = split_faults(faults)
    exps = [
        exp_mod.Experiment(topology=base, traffic=traffic, budget=budget,
                           inj_rate=inj_rate, seed=seed),
        exp_mod.Experiment(topology=base, traffic=traffic, budget=budget,
                           inj_rate=inj_rate, seed=seed, faults=faults),
        exp_mod.Experiment(topology=suggest_repair_morph(base, dead),
                           traffic=traffic, budget=budget,
                           inj_rate=inj_rate, seed=seed, faults=trans),
    ]
    healthy, faulted, repaired = exp_mod.run_experiments(exps)
    legs = {"healthy": healthy, "faulted": faulted, "repaired": repaired}
    # Static certification of the repaired twin (DESIGN.md §14): the
    # BFS-refilled route table has no paper proof behind it, and refilled
    # turns *can* re-introduce dependency cycles — say so in the result
    # instead of letting the repaired leg deadlock a later long run.
    from repro_torch.analysis import fabric
    cert = fabric.certify(exps[2].topology, device=budget.device or "cuda")
    return {
        "scenario": faults.to_dict(),
        "certified": {
            "ok": cert.ok,
            "deadlock_free": cert.prop("deadlock_free").ok,
            "route_liveness": cert.prop("route_liveness").ok,
            "witness": [dict(w) for p in cert.failures()
                        for w in p.witness[:1]],
        },
        "delivered_fraction": {k: round(r.delivered_fraction, 4)
                               for k, r in legs.items()},
        "reachability": {k: round(r.reachability, 4)
                         for k, r in legs.items()},
        "avg_latency": {k: round(r.sim.avg_latency, 2)
                        for k, r in legs.items()},
        "latency_inflation": {
            "faulted": round(faulted.latency_inflation(healthy), 4),
            "repaired": round(repaired.latency_inflation(healthy), 4)},
        "repair_gain": round(repaired.delivered_fraction
                             - faulted.delivered_fraction, 4),
    }
