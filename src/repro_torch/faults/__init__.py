"""Fault injection & graceful degradation for the Ring-Mesh NoC (port of
``repro.faults``).

``spec``   — frozen, JSON-able ``FaultSpec`` / ``LinkFault``, their
             lowering to the simulator's per-queue drop entries, and the
             seeded ``sample_faults`` generator.
``repair`` — ``suggest_repair_morph`` / ``measure_repair``: the paper's
             §5.1 fault-bypass claim, quantified (delivered fraction and
             latency before vs. after re-morphing around the faults,
             with a static certificate of the repaired fabric).

``repair`` is imported lazily: it pulls in ``core.experiment``, which
imports ``core.spec``, which imports ``faults.spec`` — an eager import
here would close that cycle.
"""
from repro_torch.faults.spec import (FABRIC_KINDS, FaultSpec, LinkFault,
                                     fabric_channels, link_between,
                                     sample_faults)

_REPAIR_NAMES = ("suggest_repair_morph", "measure_repair", "healthy_twin",
                 "merge_faults", "split_faults")

__all__ = ["FaultSpec", "LinkFault", "FABRIC_KINDS", "fabric_channels",
           "link_between", "sample_faults", *_REPAIR_NAMES]


def __getattr__(name):
    if name in _REPAIR_NAMES:
        from repro_torch.faults import repair
        return getattr(repair, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
