"""Batched sweep engine: one kernel launch per (geometry, static key).

The paper's evaluation (Figs. 9-17) is a grid of simulations over
injection rates x traffic patterns x seeds x locality regimes.  Every
per-point parameter (rate, locality, seed, destination map, trace phase
tables, fault drop masks) is data, so ``sweep()`` groups its configs by
the static key (cycles, warmup, starvation_limit, backend, device,
trace-barrier semantics) and by two array shapes — the trace phase count
and the lowered fault count, padded to buckets — and runs each group as
one batch: the batch dimension is written out in the twin and is the
kernel's grid, one thread block per point.  Results come back in input
order and are bit-identical to per-point ``sim.simulate``.

    topo = TopologySpec("ring_mesh", 256).build()
    cfgs = sweep.grid(inj_rates=(0.25, 0.5, 1.0),
                      patterns=sim.PATTERNS, seeds=(0, 1), cycles=900)
    results = sweep.sweep(topo, cfgs)       # one launch
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

from repro_torch import telemetry
from repro_torch.core import sim
from repro_torch.core import topology as topo_mod
from repro_torch.core import traffic


def _grouped(topo: topo_mod.Topology,
             cfgs: Sequence[sim.SimConfig]) -> dict[tuple, list[int]]:
    # The trace phase count and the lowered fault count are array shapes,
    # so points only batch with equal counts; statistical points all have
    # 0 phases, healthy points 0 faults, and fault lowering pads to bucket
    # sizes so nearby fault counts coincide.
    groups: dict[tuple, list[int]] = {}
    for i, c in enumerate(cfgs):
        groups.setdefault(sim._static_key(c, topo), []).append(i)
    return groups


@telemetry.spanned("sweep.sweep")
def sweep(topo: topo_mod.Topology,
          cfgs: Sequence[sim.SimConfig],
          verify: bool = False) -> list[sim.SimResult]:
    """Run every config on ``topo``, one batch per static key; results
    return in the order of ``cfgs``.

    ``verify=True`` statically certifies the fabric first (deadlock
    freedom + route liveness, ``analysis.fabric``, on the device of the
    first config; ``"cuda"`` when there is none) and raises
    ``CertificationError`` before launching anything — the pre-flight for
    long grids on morphed/repaired fabrics (DESIGN.md §14).
    """
    if verify:
        from repro_torch.analysis import fabric
        fabric.require_certified(
            topo, device=cfgs[0].torch_device() if cfgs else "cuda")
    out: list[Optional[sim.SimResult]] = [None] * len(cfgs)
    for idxs in _grouped(topo, cfgs).values():
        results, _ = sim.run_batch(topo, [cfgs[i] for i in idxs])
        for i, r in zip(idxs, results):
            out[i] = r
    return out  # type: ignore[return-value]


def grid(inj_rates: Iterable[float] = (0.25,),
         patterns: Iterable = (sim.UNIFORM,),
         seeds: Iterable[int] = (0,),
         cycles: int = 1200, warmup: int = 400,
         locality_ringlet: float = 0.0, locality_block: float = 0.0,
         starvation_limit: int = 8,
         backend: str = "cuda",
         device: Optional[str] = None,
         faults: Iterable = (None,)) -> list[sim.SimConfig]:
    """Cross-product config grid (rate-major, then pattern, then seed,
    then fault scenario).  ``patterns`` accepts legacy strings and
    ``traffic.TrafficSpec`` instances alike; the locality kwargs describe
    the grid's regime and are folded into specs that don't declare their
    own (declaring both is an error).  ``backend``/``device`` place every
    point.  ``faults`` is an axis of ``FaultSpec | None`` scenarios
    injected *unrepaired* (runtime drop masks on the healthy geometry, so
    the whole resilience grid still batches)."""
    patterns = tuple(patterns)  # re-iterated per rate: materialize so
    seeds = tuple(seeds)        # one-shot iterators work
    faults = tuple(faults)
    cfgs = []
    for ir in inj_rates:
        for p in patterns:
            lr, lb = locality_ringlet, locality_block
            if isinstance(p, traffic.TrafficSpec) and (lr or lb):
                if p.locality_ringlet or p.locality_block:
                    raise ValueError(
                        "locality declared both on grid() and on the "
                        f"TrafficSpec {traffic.name_of(p)!r}")
                p = dataclasses.replace(p, locality_ringlet=lr,
                                        locality_block=lb)
            if isinstance(p, traffic.TrafficSpec):
                lr = lb = 0.0
            cfgs.extend(
                sim.SimConfig(cycles=cycles, warmup=warmup, inj_rate=ir,
                              pattern=p, seed=s, locality_ringlet=lr,
                              locality_block=lb,
                              starvation_limit=starvation_limit,
                              backend=backend, device=device, faults=f)
                for s in seeds for f in faults)
    return cfgs


def sweep_grid(topo: topo_mod.Topology, verify: bool = False,
               **grid_kwargs) -> list[sim.SimResult]:
    """Convenience: build a ``grid(**grid_kwargs)`` and ``sweep`` it
    (``verify=True`` runs the static certification pre-flight first)."""
    return sweep(topo, grid(**grid_kwargs), verify=verify)
