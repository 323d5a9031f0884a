"""Pluggable traffic specifications — the destination-map registry.

A ``TrafficSpec`` declares *where packets go*: an optional fixed
destination map (``destinations(n_pes)``; ``None`` = uniform-random over
everyone else, drawn per cycle inside ``core.sim``) plus the ringlet /
block locality mix of the paper's operating regime (§1/§3 — the locality
fractions redirect a share of draws to near neighbours, so they ride
the sweep batch axis as data, not as static keys).

Specs are frozen, hashable dataclasses and JSON-round-trippable
(``to_json`` / ``from_json`` dispatch on the registry ``kind``), so a
spec can serve as part of an experiment cache key and survive a report
file.  The registry is open: anything outside ``repro_torch.core`` can

    @traffic.register
    @dataclasses.dataclass(frozen=True)
    class Sweep43(traffic.TrafficSpec):
        kind = "sweep43"
        def destinations(self, n_pes):
            return (np.arange(n_pes) * 43 + 1) % n_pes

and every consumer — ``SimConfig(pattern=Sweep43())``, ``sweep.grid``,
``Experiment`` — accepts it without touching the simulator.  The six
legacy string patterns (``sim.PATTERNS``) resolve here too; their maps
are bit-identical to the pre-registry ``sim.pattern_destinations``.

Documented fixed points: ``transpose`` (the diagonal) and ``shuffle``
(0 and all-ones) map some sources to themselves — such packets eject at
their source ring switch after one inject+eject transfer, exactly as the
seed simulator behaved.  Specs with ``self_free = True`` guarantee no
source targets itself at any supported size.
"""
from __future__ import annotations

import dataclasses
import json
from typing import ClassVar, Optional, Union

import numpy as np

from repro_torch.core import packet as pk

_REGISTRY: dict[str, type["TrafficSpec"]] = {}

# Kinds whose spec classes live outside ``repro_torch.core`` (open-registry
# layering: core never imports them).  ``resolve``/``from_dict`` import the
# owning module on first sight of the kind, so deserializing e.g. a trace
# report works without the caller pre-importing ``repro_torch.trace``.
_LAZY_KINDS = {"trace": "repro_torch.trace"}


def _lookup(kind: str) -> Optional[type["TrafficSpec"]]:
    cls = _REGISTRY.get(kind)
    if cls is None and kind in _LAZY_KINDS:
        import importlib

        importlib.import_module(_LAZY_KINDS[kind])
        cls = _REGISTRY.get(kind)
    return cls


def register(cls: type["TrafficSpec"]) -> type["TrafficSpec"]:
    """Class decorator: add a TrafficSpec subclass to the registry."""
    if not getattr(cls, "kind", ""):
        raise ValueError(f"{cls.__name__} must define a non-empty `kind`")
    prev = _REGISTRY.get(cls.kind)
    if prev is not None and prev is not cls:
        raise ValueError(
            f"traffic kind {cls.kind!r} already registered by {prev.__name__}")
    _REGISTRY[cls.kind] = cls
    return cls


def registered() -> dict[str, type["TrafficSpec"]]:
    """Snapshot of the registry (kind -> spec class)."""
    return dict(_REGISTRY)


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve(pattern: Union[str, "TrafficSpec"]) -> "TrafficSpec":
    """A spec instance for ``pattern``: strings look up the registry
    (default-constructed spec), instances pass through."""
    if isinstance(pattern, TrafficSpec):
        return pattern
    cls = _lookup(pattern)
    if cls is None:
        raise ValueError(
            f"unknown pattern {pattern!r}; registered: {names()}")
    return cls()


def spec(pattern: Union[str, "TrafficSpec"], **overrides) -> "TrafficSpec":
    """Resolve ``pattern`` and apply field overrides, e.g.
    ``traffic.spec("uniform", locality_ringlet=0.75)``."""
    base = resolve(pattern)
    return dataclasses.replace(base, **overrides) if overrides else base


def name_of(pattern: Union[str, "TrafficSpec"]) -> str:
    """Printable name (the registry kind) for a pattern string or spec."""
    return pattern if isinstance(pattern, str) else pattern.kind


def _require_pow2(n_pes: int, kind: str) -> int:
    bits = int(np.log2(max(n_pes, 1)))
    if (1 << bits) != n_pes:
        raise ValueError(
            f"{kind!r} traffic needs a power-of-two PE count, got {n_pes}")
    return bits


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Base spec: locality mix + an overridable destination map.

    Subclass contract: set the ClassVars, implement ``destinations``
    returning either ``None`` (uniform-random) or an int32 ``[n_pes]``
    array with every entry in ``[0, n_pes)`` — raise ``ValueError`` for
    unsupported sizes instead of producing garbage.
    """

    locality_ringlet: float = 0.0
    locality_block: float = 0.0

    kind: ClassVar[str] = ""
    is_permutation: ClassVar[bool] = False  # destinations() is a bijection
    self_free: ClassVar[bool] = False       # no source targets itself
    is_trace: ClassVar[bool] = False        # phased replay (repro_torch.trace)

    def __post_init__(self):
        if not 0 <= self.locality_ringlet + self.locality_block <= 1:
            raise ValueError("locality fractions must sum to <= 1")

    def destinations(self, n_pes: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    # -- trace protocol (overridden by repro_torch.trace.Trace) -------------
    @property
    def n_trace_phases(self) -> int:
        """Phase count for trace specs; 0 marks statistical traffic."""
        return 0

    def trace_arrays(self, n_pes: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-phase ``(dst [n_phases, P], flits [n_phases, P])`` int32
        arrays for the phase-gated replay; only valid when ``is_trace``."""
        raise NotImplementedError(f"{self.kind!r} is not a trace spec")

    def trace_records(self, n_pes: int):
        """``(start [n_phases, P], dst [R], end [R])`` int32 record tables
        where a source sends several records in a phase, else None (the
        ``trace_arrays`` say the whole trace)."""
        return None

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "TrafficSpec":
        d = dict(d)
        kind = d.pop("kind")
        cls = _lookup(kind)
        if cls is None:
            raise ValueError(
                f"unknown traffic kind {kind!r}; registered: {names()}")
        return cls(**d)

    @staticmethod
    def from_json(s: str) -> "TrafficSpec":
        return TrafficSpec.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# The six legacy patterns (bit-identical to the pre-registry maps).
# ---------------------------------------------------------------------------
@register
@dataclasses.dataclass(frozen=True)
class Uniform(TrafficSpec):
    """Uniform-random over everyone else, redrawn per cycle (self-free by
    construction: the sim draws an offset in [1, n_pes))."""

    kind: ClassVar[str] = "uniform"
    self_free: ClassVar[bool] = True

    def destinations(self, n_pes: int) -> None:
        return None


@register
@dataclasses.dataclass(frozen=True)
class BitReversal(TrafficSpec):
    kind: ClassVar[str] = "bit_reversal"
    is_permutation: ClassVar[bool] = True

    def destinations(self, n_pes: int) -> np.ndarray:
        bits = _require_pow2(n_pes, self.kind)
        return pk.bitreverse(np.arange(n_pes), bits).astype(np.int32)


@register
@dataclasses.dataclass(frozen=True)
class Transpose(TrafficSpec):
    """Matrix-transpose permutation; the diagonal is a documented fixed
    point set (those packets eject at their source)."""

    kind: ClassVar[str] = "transpose"
    is_permutation: ClassVar[bool] = True

    def destinations(self, n_pes: int) -> np.ndarray:
        bits = _require_pow2(n_pes, self.kind)
        return pk.transpose_perm(np.arange(n_pes), bits).astype(np.int32)


@register
@dataclasses.dataclass(frozen=True)
class Shuffle(TrafficSpec):
    """Perfect shuffle (rotate the address left one bit); 0 and all-ones
    are documented fixed points."""

    kind: ClassVar[str] = "shuffle"
    is_permutation: ClassVar[bool] = True

    def destinations(self, n_pes: int) -> np.ndarray:
        bits = _require_pow2(n_pes, self.kind)
        src = np.arange(n_pes)
        return (((src << 1) | (src >> (bits - 1))) & (n_pes - 1)).astype(
            np.int32)


@register
@dataclasses.dataclass(frozen=True)
class Tornado(TrafficSpec):
    """Dally & Towles: each node sends (almost) half-way around.  Works at
    any size >= 2; always a self-free permutation (constant shift)."""

    kind: ClassVar[str] = "tornado"
    is_permutation: ClassVar[bool] = True
    self_free: ClassVar[bool] = True

    def destinations(self, n_pes: int) -> np.ndarray:
        if n_pes < 2:
            raise ValueError("tornado needs >= 2 PEs")
        src = np.arange(n_pes)
        return ((src + max(1, n_pes // 2 - 1)) % n_pes).astype(np.int32)


@register
@dataclasses.dataclass(frozen=True)
class Hotspot(TrafficSpec):
    """Many-to-one(or-few) stress traffic with configurable sink weights.

    ``sinks=None`` is the legacy single-sink map: every PE targets the
    center PE (``n_pes // 2``), which itself targets PE 0.  Otherwise
    ``sinks`` is ``((pe, weight), ...)``: sources are apportioned to the
    sinks proportionally to weight (largest-remainder rounding, assigned
    in contiguous source-index runs — deterministic, no RNG).  Any source
    that lands on itself is rerouted to another sink (or its successor),
    so the map is always self-free.
    """

    sinks: Optional[tuple[tuple[int, float], ...]] = None

    kind: ClassVar[str] = "hotspot"
    self_free: ClassVar[bool] = True

    def __post_init__(self):
        super().__post_init__()
        if self.sinks is not None:
            coerced = tuple((int(s), float(w)) for s, w in self.sinks)
            if not coerced:
                raise ValueError("hotspot sinks must be non-empty")
            if any(w <= 0 for _, w in coerced):
                raise ValueError("hotspot sink weights must be > 0")
            if any(s < 0 for s, _ in coerced):
                raise ValueError("hotspot sink ids must be >= 0")
            object.__setattr__(self, "sinks", coerced)

    def destinations(self, n_pes: int) -> np.ndarray:
        if self.sinks is None:
            hot = n_pes // 2
            dst = np.full(n_pes, hot, np.int32)
            dst[hot] = 0  # the hotspot itself targets PE 0
            return dst
        if any(s >= n_pes for s, _ in self.sinks):
            raise ValueError(
                f"hotspot sink id out of range for {n_pes} PEs: {self.sinks}")
        weights = np.array([w for _, w in self.sinks], float)
        quota = n_pes * weights / weights.sum()
        counts = np.floor(quota).astype(int)
        # Largest-remainder: hand the leftover sources to the biggest
        # fractional quotas (ties broken by sink order).
        for i in np.argsort(-(quota - counts), kind="stable")[
                :n_pes - counts.sum()]:
            counts[i] += 1
        dst = np.empty(n_pes, np.int32)
        pos = 0
        for (s, _), c in zip(self.sinks, counts):
            dst[pos:pos + c] = s
            pos += c
        for i in np.nonzero(dst == np.arange(n_pes))[0]:
            alt = next((s for s, _ in self.sinks if s != i), None)
            dst[i] = alt if alt is not None else (i + 1) % n_pes
        return dst


# ---------------------------------------------------------------------------
# Collective / ML-accelerator phase traffic (beyond the paper; cf. the
# collective-capable NoC literature for large-scale ML accelerators).
# ---------------------------------------------------------------------------
@register
@dataclasses.dataclass(frozen=True)
class Collective(TrafficSpec):
    """One communication phase of a collective over all PEs.

    * ``ring_allreduce`` — the classic bandwidth-optimal ring: all
      2(N-1) reduce-scatter / all-gather phases share the same
      neighbour-shift map ``i -> (i + 1) % N`` (``phase`` is accepted for
      symmetry but does not change the map).  Any size >= 2.
    * ``halving_doubling`` — recursive halving/doubling: phase ``p``
      pairs ``i <-> i XOR 2**p``.  Power-of-two sizes only,
      ``0 <= phase < log2(N)``.

    Both are self-free permutations, so conservation and latency checks
    apply unchanged.
    """

    algorithm: str = "ring_allreduce"
    phase: int = 0

    kind: ClassVar[str] = "collective"
    is_permutation: ClassVar[bool] = True
    self_free: ClassVar[bool] = True

    _ALGORITHMS: ClassVar[tuple[str, ...]] = ("ring_allreduce",
                                              "halving_doubling")

    def __post_init__(self):
        super().__post_init__()
        if self.algorithm not in self._ALGORITHMS:
            raise ValueError(f"unknown collective algorithm "
                             f"{self.algorithm!r}; one of {self._ALGORITHMS}")
        if self.phase < 0:
            raise ValueError("collective phase must be >= 0")

    def destinations(self, n_pes: int) -> np.ndarray:
        if n_pes < 2:
            raise ValueError("collective traffic needs >= 2 PEs")
        src = np.arange(n_pes)
        if self.algorithm == "ring_allreduce":
            return ((src + 1) % n_pes).astype(np.int32)
        bits = _require_pow2(n_pes, f"{self.kind}/halving_doubling")
        if self.phase >= bits:
            raise ValueError(
                f"halving_doubling phase {self.phase} out of range for "
                f"{n_pes} PEs (log2 = {bits})")
        return (src ^ (1 << self.phase)).astype(np.int32)
