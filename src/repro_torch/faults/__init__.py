"""Fault specifications for the Ring-Mesh NoC (port of ``repro.faults``).

``spec`` — frozen, JSON-able ``FaultSpec`` / ``LinkFault`` and the seeded
``sample_faults`` generator.  Faults repaired into a fabric
(``TopologySpec(faults=...)``) are supported; runtime injection and the
repair measurements are a later slice (ROADMAP Queue 1 item 7).
"""
from repro_torch.faults.spec import (FABRIC_KINDS, FaultSpec, LinkFault,
                                     fabric_channels, link_between,
                                     sample_faults)

__all__ = ["FaultSpec", "LinkFault", "FABRIC_KINDS", "fabric_channels",
           "link_between", "sample_faults"]
