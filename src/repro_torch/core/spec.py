"""Declarative topology specs — frozen, hashable, JSON-round-trippable.

``TopologySpec`` replaces the stringly ``topology.build(name, n_pes,
**kw)`` call at the experiment API: a spec names a topology *family*
(``ring_mesh`` / ``flat_mesh``; the old aliases are canonicalized), the
PE count, the queue depths, and an ordered tuple of morph overlays
(``MorphOverlay`` — the declarative image of a §5 morph packet applied at
build time).  Because the spec is frozen and hashable it is also the
canonical geometry cache key: ``spec.build()`` memoizes the constructed
``Topology`` (including applied morphs and, transitively, the simulator's
structural geometry cache that lives on the object), so every consumer
that agrees on the spec shares one geometry and its device uploads.

``topology.build`` remains as a thin deprecation shim for the seed tests
and the frozen serial baseline; new code should construct specs.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch import telemetry
from repro_torch.core import morph as morph_mod
from repro_torch.core import packet as pk
from repro_torch.core import topology as topo_mod
from repro_torch.faults.spec import FaultSpec

FAMILIES = ("ring_mesh", "flat_mesh")
_ALIASES = {"ring_mesh": "ring_mesh", "ringmesh": "ring_mesh",
            "proposed": "ring_mesh",
            "flat_mesh": "flat_mesh", "mesh": "flat_mesh",
            "2dmesh": "flat_mesh", "baseline": "flat_mesh"}


@dataclasses.dataclass(frozen=True)
class MorphOverlay:
    """One morph application baked into a topology build (paper §5.1).

    ``hl=1`` targets mesh router ``target`` (LC groups N,S,E,W +
    4 ringlets), ``hl=0`` targets ring switch ``target`` (groups ring-CW,
    ring-CCW, PE, router).  ``link_states`` are the 8 x 2-bit states
    (0 = active, 1 = bypass, 2 = switch-off).
    """

    hl: int
    target: int
    link_states: tuple[int, ...]

    def __post_init__(self):
        if self.hl not in (0, 1):
            raise ValueError("hl must be 0 (ring switch) or 1 (router)")
        if self.target < 0:
            raise ValueError("morph target must be >= 0")
        states = tuple(int(s) for s in self.link_states)
        if len(states) != 8 or any(s not in (pk.LINK_ACTIVE, pk.LINK_BYPASS,
                                             pk.LINK_OFF) for s in states):
            raise ValueError("link_states must be 8 values in {0, 1, 2}")
        object.__setattr__(self, "link_states", states)

    def to_dict(self) -> dict:
        return {"hl": self.hl, "target": self.target,
                "link_states": list(self.link_states)}

    @classmethod
    def from_dict(cls, d: dict) -> "MorphOverlay":
        return cls(hl=d["hl"], target=d["target"],
                   link_states=tuple(d["link_states"]))


_BUILD_CACHE: dict["TopologySpec", topo_mod.Topology] = {}


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    family: str = "ring_mesh"
    n_pes: int = 64
    queue_depth: int = 2
    src_queue_depth: int = 4
    morphs: tuple[MorphOverlay, ...] = ()
    # Faults *repaired into* the fabric (``faults.spec``, DESIGN.md §13):
    # build rebuilds route tables around the dead components, masks dead
    # queues out of arbitration, and records the reachability matrix.
    # (Faults passed to SimConfig/Experiment instead are injected
    # unrepaired, as runtime drop masks on the healthy geometry.)
    faults: FaultSpec | None = None

    def __post_init__(self):
        fam = _ALIASES.get(self.family)
        if fam is None:
            raise ValueError(
                f"unknown topology family {self.family!r}; one of {FAMILIES}")
        object.__setattr__(self, "family", fam)
        grids = (topo_mod.RING_MESH_GRIDS if fam == "ring_mesh"
                 else topo_mod.FLAT_MESH_GRIDS)
        if self.n_pes not in grids:
            raise ValueError(f"unsupported {fam} size {self.n_pes}; "
                             f"one of {sorted(grids)}")
        if self.queue_depth < 1 or self.src_queue_depth < 1:
            raise ValueError("queue depths must be >= 1")
        morphs = tuple(m if isinstance(m, MorphOverlay)
                       else MorphOverlay.from_dict(m) for m in self.morphs)
        if morphs and fam != "ring_mesh":
            raise ValueError("morph overlays only apply to ring_mesh")
        object.__setattr__(self, "morphs", morphs)
        # Morph targets are range-checked here, at construction time, so a
        # bad overlay fails with a clear error instead of surfacing as a
        # silent no-op or an opaque gather error deep inside run().
        bx, by = grids[self.n_pes]
        n_routers = bx * by if fam == "ring_mesh" else self.n_pes
        for m in morphs:
            bound = n_routers if m.hl == 1 else self.n_pes
            what = "router" if m.hl == 1 else "ring switch"
            if m.target >= bound:
                raise ValueError(
                    f"morph overlay targets {what} {m.target}, but "
                    f"{fam}_{self.n_pes} has only {bound} {what}es "
                    f"(0..{bound - 1})")
        if self.faults is not None:
            flt = (self.faults if isinstance(self.faults, FaultSpec)
                   else FaultSpec.from_dict(self.faults))
            object.__setattr__(self, "faults", flt or None)

    @property
    def name(self) -> str:
        return f"{self.family}_{self.n_pes}"

    # -- construction -------------------------------------------------------
    def build_fresh(self) -> topo_mod.Topology:
        """A new Topology for this spec (morph overlays applied in order,
        then faults repaired into the route tables)."""
        t = topo_mod.build(self.family, self.n_pes,
                           queue_depth=self.queue_depth,
                           src_queue_depth=self.src_queue_depth)
        if self.morphs:
            ctl = morph_mod.MorphController(t)
            for m in self.morphs:
                ctl.apply(pk.MorphPacket(hl=m.hl, ers=0,
                                         link_states=m.link_states),
                          target=m.target)
        if self.faults is not None:
            self.faults.validate_against(t)
            dead = self.faults.dead_queue_mask(t)
            if dead.any():
                route, reach = topo_mod.reroute_avoiding(t, dead)
                t.route_table = route
                t.dead_queues = dead
                t.reachable = reach
        return t

    @telemetry.spanned("spec.TopologySpec.build")
    def build(self) -> topo_mod.Topology:
        """The memoized Topology for this spec — the canonical geometry
        cache: equal specs share one object, hence one structural geometry
        and its device uploads.  Treat the result as
        read-only; use ``build_fresh()`` to mutate (e.g. live morphing)."""
        t = _BUILD_CACHE.get(self)
        if t is None:
            t = _BUILD_CACHE[self] = self.build_fresh()
        return t

    @staticmethod
    def clear_build_cache() -> None:
        _BUILD_CACHE.clear()

    def certify(self, *, device="cuda"):
        """Static certification of this spec's built fabric (deadlock
        freedom, route liveness, table consistency — DESIGN.md §14), its
        walks on ``device`` (the card unless the caller asks for the
        CPU); returns the ``analysis.fabric.FabricCertificate``, memoized
        on this spec alongside the geometry."""
        from repro_torch.analysis import fabric  # lazy: analysis imports spec
        return fabric.certify(self, device=device)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        d = {"family": self.family, "n_pes": self.n_pes,
             "queue_depth": self.queue_depth,
             "src_queue_depth": self.src_queue_depth,
             "morphs": [m.to_dict() for m in self.morphs]}
        if self.faults is not None:
            d["faults"] = self.faults.to_dict()
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        # Only keys present in d are passed: absent depths fall back to the
        # dataclass defaults (the single source of truth).
        kw = {k: d[k] for k in ("queue_depth", "src_queue_depth") if k in d}
        if "faults" in d:
            kw["faults"] = FaultSpec.from_dict(d["faults"])
        return cls(family=d["family"], n_pes=d["n_pes"],
                   morphs=tuple(MorphOverlay.from_dict(m)
                                for m in d.get("morphs", ())), **kw)

    @classmethod
    def from_json(cls, s: str) -> "TopologySpec":
        return cls.from_dict(json.loads(s))
