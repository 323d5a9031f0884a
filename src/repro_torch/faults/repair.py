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
``healthy_twin``, ``merge_faults`` and ``split_faults`` build the legs of
a degradation comparison.  ``measure_repair`` — the healthy /
faulted-unrepaired / repaired triplet with a static certificate of the
repaired fabric — needs the fabric analysis, which is not ported yet
(ROADMAP Queue 1 item 8), and raises ``NotImplementedError``.

Transient faults (probabilistic flit drops) are behaviour, not
structure: a repair morph cannot route around a link that is merely
lossy, so transient entries stay runtime-injected on every leg of the
comparison and only dead components are repaired into the fabric.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.spec import TopologySpec
from repro_torch.faults.spec import FaultSpec

_UNPORTED_CERTIFY = ("measure_repair certifies the repaired fabric with "
                     "the static fabric analysis, which is not ported "
                     "yet: ROADMAP Queue 1 item 8 (analysis slice)")


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


def measure_repair(spec: TopologySpec, faults: FaultSpec, **kw) -> dict:
    """The reference's healthy / faulted / repaired triplet with the
    repaired fabric's certificate.  Not ported: the certificate needs the
    fabric analysis (ROADMAP Queue 1 item 8)."""
    raise NotImplementedError(_UNPORTED_CERTIFY)
