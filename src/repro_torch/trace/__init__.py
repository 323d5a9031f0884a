"""Trace-driven workload replay (port of ``repro.trace``): dist/HLO
collective schedules as dependency-aware NoC traffic (DESIGN.md §12).

``TraceSpec`` is the frozen JSON-able phase representation and
``TraceRecords`` its array-backed records form (a source may send to many
destinations in a phase); ``Trace`` is their ``TrafficSpec`` registry
adapter (kind ``"trace"``); the extractors turn ``repro.dist``-style
schedules, schedule censuses, HLO dumps and a MoE layer's routing into
traces.
"""
from repro_torch.trace.spec import (FLIT_BYTES, Trace, TraceRecords,
                                    TraceSpec, flits_for_bytes, from_records)
from repro_torch.trace.extract import (ALGORITHMS, DIST_SCHEDULES,
                                       KNOWN_KINDS, SCHEDULES_JSON,
                                       collective_phases, completion_budget,
                                       dist_to_trace, hlo_to_trace,
                                       load_schedules, moe_exchange_trace,
                                       permute_phase, schedule_to_trace,
                                       traces_for_schedules)

__all__ = [
    "FLIT_BYTES", "Trace", "TraceRecords", "TraceSpec", "flits_for_bytes",
    "from_records",
    "ALGORITHMS", "DIST_SCHEDULES", "KNOWN_KINDS", "SCHEDULES_JSON",
    "collective_phases", "completion_budget", "dist_to_trace",
    "hlo_to_trace", "load_schedules", "moe_exchange_trace", "permute_phase",
    "schedule_to_trace",
    "traces_for_schedules",
]
