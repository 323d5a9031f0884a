"""Trace representation: frozen, JSON-able multi-phase communication traces.

A ``TraceSpec`` is the contract between the workload side of the repo
(``repro.dist`` collective schedules, HLO dumps via ``launch.hlo``) and the
NoC simulator: an ordered tuple of *phases*, each phase a tuple of
``(src, dst, flits)`` records, plus phase->phase dependency edges.  The
replay engine (``core.sim``'s trace mode, DESIGN.md §12) releases phase
``i``'s packets only after every phase it depends on has fully delivered —
implemented as a phase-gated injection mask inside the cycle step
(``kernels.noc_step``), so the plain twin and the CUDA kernel replay
traces bit-identically and whole trace x topology grids batch in
``core.sweep``.

Dependency model: ``deps[i]`` lists the phases phase ``i`` waits on (every
edge must point backwards, i.e. the stored order is a topological order).
The default is the chain ``deps[i] = (i-1,)``.  The replay executes phases
*sequentially in stored order* — a full barrier between consecutive phases
— which respects any backward-pointing DAG conservatively (independent
phases are serialized, never reordered).

Flit accounting: the simulator moves single-flit packets, so byte counts
are converted with an explicit flit payload size, ``FLIT_BYTES`` (default
32 B — the paper's 32-bit phits grouped 8-to-a-flit; override per trace
via ``TraceSpec.flit_bytes``).  ``flits_for_bytes`` additionally takes a
``scale`` divisor so terabyte-scale collective schedules replay at a
tractable cycle budget with relative per-phase volumes preserved (the
scale used is recorded on the spec for the report).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import ClassVar, Sequence

import numpy as np

from repro_torch.core import traffic

#: Default flit payload in bytes.  The paper's link is a 32-bit phit
#: channel; we model an 8-phit flit = 32 bytes of payload per simulator
#: packet.  Every byte->flit conversion states its flit size explicitly.
FLIT_BYTES = 32


def flits_for_bytes(nbytes: float, flit_bytes: int = FLIT_BYTES,
                    scale: float = 1.0) -> int:
    """Flits carrying ``nbytes`` of payload at ``flit_bytes`` per flit.

    ``scale`` divides the byte volume first (for replaying huge schedules
    at reduced absolute volume); any positive byte count maps to >= 1
    flit so scaled phases never vanish.
    """
    if nbytes < 0:
        raise ValueError(f"byte count must be >= 0, got {nbytes}")
    if flit_bytes <= 0:
        raise ValueError(f"flit_bytes must be > 0, got {flit_bytes}")
    if scale <= 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    if nbytes == 0:
        return 0
    return max(1, math.ceil(nbytes / (flit_bytes * scale)))


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A multi-phase communication trace over ``n_pes`` PEs.

    ``phases`` is a tuple of phases; each phase is a tuple of
    ``(src, dst, flits)`` int records.  Within a phase each source sends
    to at most one destination (the builders in ``repro_torch.trace.extract``
    split richer patterns into sub-phases); sources absent from a phase
    are idle.  ``deps`` are the dependency edges (see module docstring);
    ``()`` means the default chain.  ``flit_bytes`` documents the byte
    size of one flit for this trace; ``scale`` records the byte-volume
    divisor applied when the trace was extracted (1.0 = unscaled).
    """

    n_pes: int
    phases: tuple[tuple[tuple[int, int, int], ...], ...]
    flit_bytes: int = FLIT_BYTES
    scale: float = 1.0
    deps: tuple[tuple[int, ...], ...] = ()
    label: str = ""

    def __post_init__(self):
        if self.n_pes < 2:
            raise ValueError(f"a trace needs >= 2 PEs, got {self.n_pes}")
        if self.flit_bytes <= 0:
            raise ValueError("flit_bytes must be > 0")
        if self.scale <= 0:
            raise ValueError("scale must be > 0")
        phases = tuple(
            tuple((int(s), int(d), int(f)) for s, d, f in ph)
            for ph in self.phases)
        if not phases:
            raise ValueError("a trace needs at least one phase")
        for i, ph in enumerate(phases):
            if not ph:
                raise ValueError(f"phase {i} is empty")
            seen: set[int] = set()
            for s, d, f in ph:
                if not (0 <= s < self.n_pes and 0 <= d < self.n_pes):
                    raise ValueError(
                        f"phase {i}: record ({s}, {d}, {f}) out of range "
                        f"for {self.n_pes} PEs")
                if s == d:
                    raise ValueError(
                        f"phase {i}: source {s} targets itself")
                if f <= 0:
                    raise ValueError(
                        f"phase {i}: record ({s}, {d}, {f}) needs flits > 0")
                if s in seen:
                    raise ValueError(
                        f"phase {i}: source {s} appears twice (one "
                        f"destination per source per phase; split into "
                        f"sub-phases)")
                seen.add(s)
        object.__setattr__(self, "phases", phases)
        deps = tuple(tuple(int(p) for p in dp) for dp in self.deps)
        if deps:
            if len(deps) != len(phases):
                raise ValueError(
                    f"deps must cover every phase: got {len(deps)} for "
                    f"{len(phases)} phases")
            for i, dp in enumerate(deps):
                if any(not 0 <= p < i for p in dp):
                    raise ValueError(
                        f"phase {i} dependency {dp} must point to an "
                        f"earlier phase (stored order is topological)")
        object.__setattr__(self, "deps", deps)

    # -- derived ------------------------------------------------------------
    @property
    def n_phases(self) -> int:
        return len(self.phases)

    @property
    def total_flits(self) -> int:
        return sum(f for ph in self.phases for _, _, f in ph)

    @property
    def max_phase_flits(self) -> int:
        """Largest per-PE flit count of any phase (budget sizing)."""
        return max(f for ph in self.phases for _, _, f in ph)

    def dependencies(self) -> tuple[tuple[int, ...], ...]:
        """Effective dependency edges (the default chain when unset)."""
        if self.deps:
            return self.deps
        return tuple((i - 1,) if i else () for i in range(self.n_phases))

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Device-ready ``(dst, flits)`` int32 arrays of shape
        ``[n_phases, n_pes]``; idle sources carry flits 0 (dst unused)."""
        nph, p = self.n_phases, self.n_pes
        dst = np.zeros((nph, p), np.int32)
        flits = np.zeros((nph, p), np.int32)
        for i, ph in enumerate(self.phases):
            for s, d, f in ph:
                dst[i, s] = d
                flits[i, s] = f
        return dst, flits

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"n_pes": self.n_pes,
                "phases": [[list(rec) for rec in ph] for ph in self.phases],
                "flit_bytes": self.flit_bytes, "scale": self.scale,
                "deps": [list(dp) for dp in self.deps],
                "label": self.label}

    def to_json(self, indent=None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceSpec":
        return cls(
            n_pes=d["n_pes"],
            phases=tuple(tuple(tuple(rec) for rec in ph)
                         for ph in d["phases"]),
            flit_bytes=d.get("flit_bytes", FLIT_BYTES),
            scale=d.get("scale", 1.0),
            deps=tuple(tuple(dp) for dp in d.get("deps", ())),
            label=d.get("label", ""))

    @classmethod
    def from_json(cls, s: str) -> "TraceSpec":
        return cls.from_dict(json.loads(s))


@traffic.register
@dataclasses.dataclass(frozen=True)
class Trace(traffic.TrafficSpec):
    """Registry entry adapting a ``TraceSpec`` to the traffic protocol.

    ``SimConfig(pattern=Trace(trace=spec))`` switches the simulator into
    phase-gated replay: packets come from the trace's phases instead of
    statistical draws, and ``inj_rate`` acts as a per-PE bandwidth
    throttle (1.0 = inject as fast as back-pressure allows).  Locality
    mixing does not apply to traces (the trace *is* the spatial pattern)
    and warmup must be 0 (completion cycles count from cycle 0) —
    ``SimConfig`` enforces both with clear errors.
    """

    trace: TraceSpec = None  # type: ignore[assignment]

    kind: ClassVar[str] = "trace"
    self_free: ClassVar[bool] = True
    is_trace: ClassVar[bool] = True

    def __post_init__(self):
        super().__post_init__()
        if isinstance(self.trace, dict):
            object.__setattr__(self, "trace", TraceSpec.from_dict(self.trace))
        if not isinstance(self.trace, TraceSpec):
            raise TypeError("Trace needs a TraceSpec (trace=...)")
        if self.locality_ringlet or self.locality_block:
            raise ValueError(
                "locality mixing does not apply to trace replay; the trace "
                "itself is the spatial pattern")

    def destinations(self, n_pes: int) -> None:
        """Statistical destination map — unused in trace mode (the
        per-phase maps come from ``trace_arrays``)."""
        self._check_size(n_pes)
        return None

    @property
    def n_trace_phases(self) -> int:
        return self.trace.n_phases

    def trace_arrays(self, n_pes: int) -> tuple[np.ndarray, np.ndarray]:
        self._check_size(n_pes)
        return self.trace.arrays()

    def _check_size(self, n_pes: int) -> None:
        if n_pes != self.trace.n_pes:
            raise ValueError(
                f"trace {self.trace.label or '<unlabeled>'!r} was extracted "
                f"for {self.trace.n_pes} PEs but the topology has {n_pes}; "
                f"re-extract the trace for this size")

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"kind": self.kind, "locality_ringlet": self.locality_ringlet,
                "locality_block": self.locality_block,
                "trace": self.trace.to_dict()}


def from_records(n_pes: int, phases: Sequence[Sequence[tuple]],
                 **kw) -> Trace:
    """Convenience: a ``Trace`` traffic spec straight from phase records."""
    return Trace(trace=TraceSpec(n_pes=n_pes,
                                 phases=tuple(tuple(tuple(r) for r in ph)
                                              for ph in phases), **kw))
