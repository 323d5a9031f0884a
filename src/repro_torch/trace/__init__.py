"""Trace-driven workload replay (port of ``repro.trace``): dist/HLO
collective schedules as dependency-aware NoC traffic (DESIGN.md §12).

``TraceSpec`` is the frozen JSON-able phase representation; ``Trace`` is
its ``TrafficSpec`` registry adapter (kind ``"trace"``); the extractors
turn ``repro.dist``-style schedules, schedule censuses, and HLO dumps into
traces.
"""
from repro_torch.trace.spec import (FLIT_BYTES, Trace, TraceSpec,
                                    flits_for_bytes, from_records)
from repro_torch.trace.extract import (ALGORITHMS, DIST_SCHEDULES,
                                       KNOWN_KINDS, SCHEDULES_JSON,
                                       collective_phases, completion_budget,
                                       dist_to_trace, hlo_to_trace,
                                       load_schedules, permute_phase,
                                       schedule_to_trace,
                                       traces_for_schedules)

__all__ = [
    "FLIT_BYTES", "Trace", "TraceSpec", "flits_for_bytes", "from_records",
    "ALGORITHMS", "DIST_SCHEDULES", "KNOWN_KINDS", "SCHEDULES_JSON",
    "collective_phases", "completion_budget", "dist_to_trace",
    "hlo_to_trace", "load_schedules", "permute_phase", "schedule_to_trace",
    "traces_for_schedules",
]
