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

Records form: in a ``TraceSpec`` phase each source sends to one
destination.  ``TraceRecords`` holds phases in which a source sends an
ordered list of ``(dst, flits)`` records (an expert-parallel all-to-all:
one source, many experts), as arrays, since such a phase may hold a
hundred thousand records.  The replay walks each source's list with a
cursor beside its sent count, so a source's records leave back to back,
with no barrier between them.

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
    split richer patterns into sub-phases; ``TraceRecords`` holds phases
    whose sources send to several); sources absent from a phase are idle.  ``deps`` are the dependency edges (see module docstring);
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
                        f"sub-phases, or use TraceRecords)")
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


@dataclasses.dataclass(frozen=True, eq=False)
class TraceRecords:
    """A multi-phase trace in records form: a source may send to several
    destinations in one phase, as an ordered list of ``(dst, flits)``
    records, and the whole table is held as arrays.

    ``phase``, ``src``, ``dst`` and ``flits`` are equal-length int32
    arrays, one entry a record.  A source injects its records of a phase
    in their stored order, each record's flits straight after the last
    flit of the one before; the phases run in order behind a full barrier,
    as ``TraceSpec``'s do.  The constructor validates the table and sorts
    it stably by (phase, source), so each source's records stay in their
    stored order.  ``TraceSpec`` keeps its one-destination rule; this is
    the only form that lifts it.  Equality and hashing are by identity
    (the arrays have neither)."""

    n_pes: int
    n_phases: int
    phase: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    flits: np.ndarray
    flit_bytes: int = FLIT_BYTES
    scale: float = 1.0
    label: str = ""

    def __post_init__(self):
        if self.n_pes < 2:
            raise ValueError(f"a trace needs >= 2 PEs, got {self.n_pes}")
        if self.n_phases < 1:
            raise ValueError("a trace needs at least one phase")
        if self.flit_bytes <= 0 or self.scale <= 0:
            raise ValueError("flit_bytes and scale must be > 0")
        cols = [np.asarray(a) for a in (self.phase, self.src, self.dst,
                                        self.flits)]
        n = cols[0].shape
        if any(c.ndim != 1 or c.shape != n
               or not np.issubdtype(c.dtype, np.integer) for c in cols):
            raise ValueError("phase, src, dst and flits must be 1-D integer "
                             "arrays of one length")
        ph, s, d, f = (c.astype(np.int64) for c in cols)
        bad = ((ph < 0) | (ph >= self.n_phases) | (s < 0) | (s >= self.n_pes)
               | (d < 0) | (d >= self.n_pes))
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(f"record {i} (phase {ph[i]}, {s[i]} -> {d[i]}) "
                             f"out of range for {self.n_phases} phases and "
                             f"{self.n_pes} PEs")
        for what, mask in (("targets itself", s == d),
                           ("needs flits > 0", f <= 0)):
            if mask.any():
                i = int(np.argmax(mask))
                raise ValueError(f"record {i} (phase {ph[i]}, {s[i]} -> "
                                 f"{d[i]}) {what}")
        if f.sum(dtype=np.int64) >= 1 << 31:
            raise ValueError("a trace holds fewer than 2**31 flits")
        empty = np.bincount(ph, minlength=self.n_phases) == 0
        if empty.any():
            raise ValueError(f"phase {int(np.argmax(empty))} is empty")
        order = np.argsort(ph * self.n_pes + s, kind="stable")
        for name, c in zip(("phase", "src", "dst", "flits"), (ph, s, d, f)):
            object.__setattr__(self, name, c[order].astype(np.int32))

    # -- derived ------------------------------------------------------------
    @property
    def n_records(self) -> int:
        return int(self.src.shape[0])

    def _key(self) -> np.ndarray:
        return self.phase.astype(np.int64) * self.n_pes + self.src

    def source_totals(self) -> np.ndarray:
        """Flits each source sends in each phase, [n_phases, n_pes] int32."""
        tot = np.bincount(self._key(), weights=self.flits,
                          minlength=self.n_phases * self.n_pes)
        return tot.astype(np.int32).reshape(self.n_phases, self.n_pes)

    def max_records_per_source(self) -> int:
        return int(np.bincount(self._key()).max())

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """``(dst, flits)`` [n_phases, n_pes] int32: each source's first
        record's destination, and the flits it sends in the phase (0 for an
        idle source)."""
        key = self._key()
        first = np.ones(self.n_records, bool)
        first[1:] = key[1:] != key[:-1]
        dst = np.zeros(self.n_phases * self.n_pes, np.int32)
        dst[key[first]] = self.dst[first]
        return dst.reshape(self.n_phases, self.n_pes), self.source_totals()

    def records(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(start [n_phases, n_pes], dst [R], end [R])`` int32: the index
        of each source's first record of each phase in the (phase,
        source)-sorted table, each record's destination, and the source's
        flits sent once the record is done (a running sum that restarts at
        each source's first record of a phase)."""
        key = self._key()
        start = np.searchsorted(key, np.arange(self.n_phases * self.n_pes))
        run = np.cumsum(self.flits, dtype=np.int64)
        before = np.concatenate([[0], run])[start]   # flits ahead of a key
        end = run - before[key]
        return (start.astype(np.int32).reshape(self.n_phases, self.n_pes),
                self.dst.copy(), end.astype(np.int32))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"n_pes": self.n_pes, "n_phases": self.n_phases,
                "records": {k: getattr(self, k).tolist()
                            for k in ("phase", "src", "dst", "flits")},
                "flit_bytes": self.flit_bytes, "scale": self.scale,
                "label": self.label}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRecords":
        return cls(n_pes=d["n_pes"], n_phases=d["n_phases"],
                   **{k: np.asarray(v, np.int32)
                      for k, v in d["records"].items()},
                   flit_bytes=d.get("flit_bytes", FLIT_BYTES),
                   scale=d.get("scale", 1.0), label=d.get("label", ""))


@traffic.register
@dataclasses.dataclass(frozen=True)
class Trace(traffic.TrafficSpec):
    """Registry entry adapting a ``TraceSpec`` or a ``TraceRecords`` to
    the traffic protocol.

    ``SimConfig(pattern=Trace(trace=spec))`` switches the simulator into
    phase-gated replay: packets come from the trace's phases instead of
    statistical draws, and ``inj_rate`` acts as a per-PE bandwidth
    throttle (1.0 = inject as fast as back-pressure allows).  Locality
    mixing does not apply to traces (the trace *is* the spatial pattern)
    and warmup must be 0 (completion cycles count from cycle 0) —
    ``SimConfig`` enforces both with clear errors.
    """

    trace: TraceSpec | TraceRecords = None  # type: ignore[assignment]

    kind: ClassVar[str] = "trace"
    self_free: ClassVar[bool] = True
    is_trace: ClassVar[bool] = True

    def __post_init__(self):
        super().__post_init__()
        if isinstance(self.trace, dict):
            cls = TraceRecords if "records" in self.trace else TraceSpec
            object.__setattr__(self, "trace", cls.from_dict(self.trace))
        if not isinstance(self.trace, (TraceSpec, TraceRecords)):
            raise TypeError("Trace needs a TraceSpec or TraceRecords "
                            "(trace=...)")
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

    def trace_records(self, n_pes: int):
        """``TraceRecords.records()`` where a source sends more than one
        record in a phase; None where each sends at most one, which
        ``trace_arrays`` says whole."""
        self._check_size(n_pes)
        if (isinstance(self.trace, TraceSpec)
                or self.trace.max_records_per_source() <= 1):
            return None
        return self.trace.records()

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
