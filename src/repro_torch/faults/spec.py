"""Fault specifications — frozen, JSON-able descriptions of broken fabric.

The paper motivates its morphing mechanism partly as a *fault bypass*
(§5.1: overlays reroute rings around broken segments), but a simulator of
a perfect fabric cannot express the claim.  ``FaultSpec`` closes that gap:
it names dead physical channels, dead mesh routers, and per-link transient
flit-drop probabilities with optional onset cycles (a link that starts
failing mid-run), in the id spaces of ``core.topology``:

* ``dead_links`` — physical channel ids (``Topology.link_phys``); a dead
  channel kills every VC queue sharing the wire.
* ``dead_routers`` — router indices (``0 .. Topology.n_routers``): every
  fabric channel touching the router's node dies.  PE inject/eject
  buffers survive (the PE is orphaned, not deleted), so ring-local
  traffic keeps flowing in a ring-mesh — the paper's degradation story.
* ``transient`` — ``LinkFault(link, drop_p, onset)`` records: from cycle
  ``onset`` on, a flit traversing the channel is dropped with
  probability ``drop_p`` (1.0 + onset>0 models a hard mid-run failure).

A ``FaultSpec`` is *where you attach it*:

* ``SimConfig(faults=...)`` / ``Experiment(faults=...)`` — the faults are
  injected at run time as a per-link drop mask inside the cycle step
  (``kernels.noc_step``; dead components lower to permanent drop
  entries).  Routing is untouched — traffic routed into a dead channel is
  dropped, the paper's switched-off semantics — and the lowered arrays
  are per-point data, so a whole resilience grid (fault count x fault
  seed x drop rate) runs as one batch on the healthy geometry.
* ``TopologySpec(faults=...)`` — the *repaired* fabric: route tables are
  rebuilt around the dead components (``topology.reroute_avoiding``),
  dead queues are masked out of the structural fan-in candidate tables,
  and truly disconnected (src, dst) pairs are reported on the topology
  instead of crashing.  ``repro_torch.faults.suggest_repair_morph`` maps
  an injected spec to its repaired twin.

Lowered entry counts are padded to a small static bucket (``_PAD_FLOOR``
minimum, then powers of two) so nearby fault counts share one batch shape
— the "fault shape" that joins ``core.sweep``'s grouping.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.core import topology as topo_mod

# Queue kinds a fault may target: fabric channels, not PE inject/eject
# buffers (a fault there is a dead PE, not a dead link).
FABRIC_KINDS = (topo_mod.RING, topo_mod.RS2R, topo_mod.R2RS, topo_mod.MESH)

# Minimum padded entry count: fault sets of up to _PAD_FLOOR lowered
# queues share one static shape (and one batch), then powers of two.
_PAD_FLOOR = 16


def _pad_bucket(n: int) -> int:
    if n <= 0:
        return 0
    b = _PAD_FLOOR
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """One faulty physical channel: from cycle ``onset`` on, each flit
    traversing it is dropped with probability ``drop_p``."""

    link: int
    drop_p: float = 1.0
    onset: int = 0

    def __post_init__(self):
        if self.link < 0:
            raise ValueError(f"fault link id must be >= 0, got {self.link}")
        if not 0.0 < self.drop_p <= 1.0:
            raise ValueError(
                f"drop_p must be in (0, 1], got {self.drop_p}")
        if self.onset < 0:
            raise ValueError(f"onset cycle must be >= 0, got {self.onset}")

    def to_dict(self) -> dict:
        return {"link": self.link, "drop_p": self.drop_p,
                "onset": self.onset}

    @classmethod
    def from_dict(cls, d: dict) -> "LinkFault":
        return cls(link=d["link"], drop_p=d.get("drop_p", 1.0),
                   onset=d.get("onset", 0))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A set of fabric faults (see module docstring for the id spaces
    and the injected-vs-repaired attachment semantics)."""

    dead_links: tuple[int, ...] = ()
    dead_routers: tuple[int, ...] = ()
    transient: tuple[LinkFault, ...] = ()

    def __post_init__(self):
        links = tuple(int(x) for x in self.dead_links)
        routers = tuple(int(x) for x in self.dead_routers)
        if any(x < 0 for x in links + routers):
            raise ValueError("fault link/router ids must be >= 0")
        if len(set(links)) != len(links):
            raise ValueError(f"duplicate dead_links: {links}")
        if len(set(routers)) != len(routers):
            raise ValueError(f"duplicate dead_routers: {routers}")
        trans = tuple(t if isinstance(t, LinkFault)
                      else LinkFault.from_dict(t) if isinstance(t, dict)
                      else LinkFault(*t) for t in self.transient)
        object.__setattr__(self, "dead_links", links)
        object.__setattr__(self, "dead_routers", routers)
        object.__setattr__(self, "transient", trans)

    def __bool__(self) -> bool:
        return bool(self.dead_links or self.dead_routers or self.transient)

    # -- validation ----------------------------------------------------------
    def validate_against(self, topo: topo_mod.Topology) -> None:
        """Range- and kind-check every fault id against ``topo``; raises
        ``ValueError`` with the offending id (called at ``Experiment``
        construction so bad ids fail fast, not as opaque gather errors
        deep inside ``run()``)."""
        fabric = np.isin(topo.link_kind, FABRIC_KINDS)
        for lid in self.dead_links + tuple(t.link for t in self.transient):
            if not 0 <= lid < topo.n_phys:
                raise ValueError(
                    f"fault link id {lid} out of range for {topo.name} "
                    f"(physical channels: 0..{topo.n_phys - 1})")
            if not fabric[topo.link_phys == lid].any():
                raise ValueError(
                    f"fault link id {lid} is a PE inject/eject buffer of "
                    f"{topo.name}, not a fabric channel; kill the router "
                    f"or model a dead PE at the workload level")
        for r in self.dead_routers:
            if not 0 <= r < topo.n_routers:
                raise ValueError(
                    f"dead router {r} out of range for {topo.name} "
                    f"(routers: 0..{topo.n_routers - 1})")

    # -- lowering ------------------------------------------------------------
    def dead_queue_mask(self, topo: topo_mod.Topology) -> np.ndarray:
        """Bool [n_links] mask of queues killed by the *permanent* faults
        (dead links + dead routers; transient faults are behaviour, not
        structure)."""
        dead = np.zeros(topo.n_links, bool)
        if self.dead_links:
            dead |= np.isin(topo.link_phys, np.asarray(self.dead_links))
        for r in self.dead_routers:
            node = r + (topo.n_pes if topo.n_ringlets else 0)
            dead |= ((topo.link_src_node == node)
                     | (topo.link_dst_node == node))
        # Faults never touch the PE inject/eject buffers (see docstring).
        dead &= np.isin(topo.link_kind, FABRIC_KINDS)
        return dead

    def lower(self, topo: topo_mod.Topology
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Queue-level drop-mask arrays ``(links, drop_p, onset)`` for the
        simulator: one entry per faulty VC queue (dead components become
        permanent ``drop_p=1.0`` entries), padded to the static bucket
        shape.  Pad entries point at the dummy queue row ``n_links`` with
        ``drop_p=0`` so they can never fire.
        """
        entries: list[tuple[int, float, int]] = []
        for q in np.nonzero(self.dead_queue_mask(topo))[0]:
            entries.append((int(q), 1.0, 0))
        for t in self.transient:
            for q in np.nonzero(topo.link_phys == t.link)[0]:
                entries.append((int(q), t.drop_p, t.onset))
        pad = _pad_bucket(len(entries))
        links = np.full(pad, topo.n_links, np.int32)
        drop_p = np.zeros(pad, np.float32)
        onset = np.zeros(pad, np.int32)
        for i, (q, p, o) in enumerate(entries):
            links[i], drop_p[i], onset[i] = q, p, o
        return links, drop_p, onset

    def n_lowered(self, topo: topo_mod.Topology) -> int:
        """Padded entry count — the static "fault shape" that joins the
        sweep's grouping key."""
        n = int(self.dead_queue_mask(topo).sum())
        n += sum(int((topo.link_phys == t.link).sum())
                 for t in self.transient)
        return _pad_bucket(n)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return {"dead_links": list(self.dead_links),
                "dead_routers": list(self.dead_routers),
                "transient": [t.to_dict() for t in self.transient]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(dead_links=tuple(d.get("dead_links", ())),
                   dead_routers=tuple(d.get("dead_routers", ())),
                   transient=tuple(LinkFault.from_dict(t)
                                   for t in d.get("transient", ())))

    @classmethod
    def from_json(cls, s: str) -> "FaultSpec":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Helpers: seeded random fault sets and channel lookup.
# ---------------------------------------------------------------------------
def fabric_channels(topo: topo_mod.Topology,
                    kinds: tuple[int, ...] = FABRIC_KINDS) -> np.ndarray:
    """Sorted physical channel ids of the given fabric queue kinds."""
    mask = np.isin(topo.link_kind, kinds)
    return np.unique(topo.link_phys[mask])


def link_between(topo: topo_mod.Topology, src_node: int,
                 dst_node: int) -> int:
    """The physical channel id of the directed ``src_node -> dst_node``
    fabric channel (for targeting a specific segment in tests/examples)."""
    hit = np.nonzero((topo.link_src_node == src_node)
                     & (topo.link_dst_node == dst_node)
                     & np.isin(topo.link_kind, FABRIC_KINDS))[0]
    if hit.size == 0:
        raise ValueError(
            f"no fabric channel {src_node} -> {dst_node} in {topo.name}")
    return int(topo.link_phys[hit[0]])


def sample_faults(topo: topo_mod.Topology, n_dead_links: int = 0,
                  n_dead_routers: int = 0, n_transient: int = 0,
                  drop_p: float = 0.05, onset: int = 0,
                  seed: int = 0,
                  kinds: tuple[int, ...] = FABRIC_KINDS) -> "FaultSpec":
    """A seeded random ``FaultSpec`` over ``topo``'s fabric channels —
    the generator behind resilience sweeps (fault count and fault seed
    become grid axes; the sampled spec is deterministic in ``seed``)."""
    rng = np.random.default_rng(seed)
    chans = fabric_channels(topo, kinds)
    total = n_dead_links + n_transient
    if total > chans.size:
        raise ValueError(
            f"cannot sample {total} distinct faulty channels from "
            f"{chans.size} fabric channels of {topo.name}")
    if n_dead_routers > topo.n_routers:
        raise ValueError(
            f"cannot sample {n_dead_routers} dead routers from "
            f"{topo.n_routers} routers of {topo.name}")
    picked = rng.choice(chans, size=total, replace=False) if total else []
    dead = tuple(int(c) for c in picked[:n_dead_links])
    trans = tuple(LinkFault(int(c), drop_p=drop_p, onset=onset)
                  for c in picked[n_dead_links:])
    routers = tuple(
        int(r) for r in rng.choice(topo.n_routers, size=n_dead_routers,
                                   replace=False)) if n_dead_routers else ()
    return FaultSpec(dead_links=dead, dead_routers=routers, transient=trans)
