"""Declarative experiment API: TopologySpec x TrafficSpec x Budget -> Report.

The paper's headline claims (2x throughput when PEs double, 141.3% power
saving at 1024 PEs, latency advantage under the locality regime) are
*joint* statements over the cycle simulator, the power and area models,
and the analytic bounds.  ``Experiment`` is the one object that states a
scenario declaratively and ``Report`` the one object that joins all four
result surfaces, JSON-round-trippable end to end:

    exp = Experiment(topology=TopologySpec("ring_mesh", 256),
                     traffic=traffic.spec("uniform", locality_ringlet=0.75,
                                          locality_block=0.20),
                     budget=Budget(cycles=1200, warmup=400),
                     inj_rate=0.625)
    report = exp.run()                  # one point
    reports = exp.run_grid(             # whole grid, one batched launch
        inj_rates=(0.25, 0.5, 1.0),
        traffics=("uniform", traffic.Collective()))
    Report.from_json(report.to_json())  # == report

Execution rides the port's engines — ``run()`` on ``sim.simulate`` and
``run_grid()``/``run_experiments()`` on the batched ``core.sweep``
(grouped by topology spec, one kernel launch per geometry) — and the
reports are bit-identical to the reference package's for the same
experiment, apart from the backend's name.  ``Budget(backend="cuda")``,
the default, runs on the card; ``Budget(backend="torch", device="cpu")``
runs the plain twin on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional, Sequence, Union

from repro_torch import telemetry
from repro_torch.core import analytic, area, power, sim, sweep, traffic
from repro_torch.core.spec import TopologySpec
from repro_torch.faults.spec import FaultSpec


@dataclasses.dataclass(frozen=True)
class Budget:
    """Simulation budget: how long to run and measure one point, and which
    simulator backend executes it (``"cuda"`` kernel / ``"torch"`` plain
    twin — bit-identical) on which device (None = ``"cuda"``).  The device
    is placement, not identity: it is left out of equality and of the JSON
    form, as on ``sim.SimConfig``.  ``strict_barrier`` and ``watchdog``
    are trace-replay semantics (DESIGN.md §13): strict barriers retire
    only *delivered* flits (drops leave credits unretired), and a non-zero
    watchdog aborts a replay after that many consecutive cycles of zero
    progress in a phase, recording the stalled phase and its unretired
    credit instead of spinning to budget exhaustion."""

    cycles: int = 1200
    warmup: int = 400
    starvation_limit: int = 8
    backend: str = "cuda"
    strict_barrier: bool = False
    watchdog: int = 0
    device: Optional[str] = dataclasses.field(default=None, compare=False)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "device"}

    @classmethod
    def from_dict(cls, d: dict) -> "Budget":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class AnalyticBounds:
    """Closed-form §6 characterization attached to every report."""

    diameter: int
    bisection_links: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AnalyticBounds":
        return cls(**d)


def _bounds(topology: TopologySpec) -> AnalyticBounds:
    if topology.family == "ring_mesh":
        return AnalyticBounds(
            diameter=analytic.ring_mesh_diameter(topology.n_pes),
            bisection_links=analytic.ring_mesh_bisection(topology.n_pes))
    return AnalyticBounds(
        diameter=analytic.flat_mesh_diameter(topology.n_pes),
        bisection_links=analytic.flat_mesh_bisection(topology.n_pes))


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One declarative scenario.  ``traffic`` accepts a registry kind
    string (resolved at construction) or a TrafficSpec instance."""

    topology: TopologySpec
    traffic: Union[str, traffic.TrafficSpec] = traffic.Uniform()
    budget: Budget = Budget()
    inj_rate: float = 0.25
    seed: int = 0
    # Faults injected *unrepaired* at runtime (drop masks on the healthy
    # geometry — a resilience grid still batches, DESIGN.md §13).  Faults
    # *repaired into* the fabric belong on the TopologySpec instead.
    faults: Optional[FaultSpec] = None
    # Opt-in static certification pre-flight (DESIGN.md §14): construction
    # proves the built fabric deadlock-free and route-live
    # (``analysis.fabric.require_certified``, on the budget's device)
    # before any cycle is simulated.  Certificates are cached on the spec,
    # so a verified grid pays the proof once per geometry.
    verify: bool = False

    def __post_init__(self):
        if not isinstance(self.topology, TopologySpec):
            raise TypeError("topology must be a TopologySpec")
        object.__setattr__(self, "traffic", traffic.resolve(self.traffic))
        if not isinstance(self.budget, Budget):
            raise TypeError("budget must be a Budget")
        if self.faults is not None:
            flt = (self.faults if isinstance(self.faults, FaultSpec)
                   else FaultSpec.from_dict(self.faults))
            object.__setattr__(self, "faults", flt or None)
        if self.faults is not None:
            # Fail here, at construction, with the offending id named —
            # not as an opaque gather error inside a batched dispatch.
            self.faults.validate_against(self.topology.build())
        if self.verify:
            from repro_torch.analysis import fabric
            fabric.require_certified(self.topology,
                                     device=self.budget.device or "cuda")
        self.sim_config()  # surface budget/traffic conflicts eagerly too

    # -- execution ----------------------------------------------------------
    def sim_config(self) -> sim.SimConfig:
        return sim.SimConfig(
            cycles=self.budget.cycles, warmup=self.budget.warmup,
            inj_rate=self.inj_rate, pattern=self.traffic, seed=self.seed,
            starvation_limit=self.budget.starvation_limit,
            backend=self.budget.backend, faults=self.faults,
            strict_barrier=self.budget.strict_barrier,
            watchdog=self.budget.watchdog, device=self.budget.device)

    def run(self) -> "Report":
        """Run this one point (bit-identical to the batched path, which
        the sweep tests assert)."""
        r = sim.simulate(self.topology.build(), self.sim_config())
        return _report(self, r)

    def run_grid(self, inj_rates: Optional[Iterable[float]] = None,
                 traffics: Optional[Iterable] = None,
                 seeds: Optional[Iterable[int]] = None,
                 faults: Optional[Iterable] = None) -> list["Report"]:
        """Cross-product grid around this experiment (rate-major, then
        traffic, then seed, then fault scenario — the ``sweep.grid``
        order), executed as batched kernel launches on the sweep engine.
        Omitted axes default to this experiment's own value; ``faults``
        takes ``FaultSpec | None`` entries (a resilience grid still
        batches — fault drop masks are per-point data)."""
        # Materialize each axis once: a one-shot iterator re-iterated by
        # the inner comprehension loops would silently truncate the grid.
        irs = tuple(inj_rates) if inj_rates is not None else (self.inj_rate,)
        trs = tuple(traffics) if traffics is not None else (self.traffic,)
        sds = tuple(seeds) if seeds is not None else (self.seed,)
        fls = tuple(faults) if faults is not None else (self.faults,)
        exps = [dataclasses.replace(self, inj_rate=ir, traffic=tr, seed=s,
                                    faults=f)
                for ir in irs for tr in trs for s in sds for f in fls]
        return run_experiments(exps)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        d = {"topology": self.topology.to_dict(),
             "traffic": self.traffic.to_dict(),
             "budget": self.budget.to_dict(),
             "inj_rate": self.inj_rate, "seed": self.seed}
        if self.faults is not None:
            d["faults"] = self.faults.to_dict()
        if self.verify:
            d["verify"] = True
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "Experiment":
        return cls(topology=TopologySpec.from_dict(d["topology"]),
                   traffic=traffic.TrafficSpec.from_dict(d["traffic"]),
                   budget=Budget.from_dict(d["budget"]),
                   inj_rate=d["inj_rate"], seed=d["seed"],
                   faults=(FaultSpec.from_dict(d["faults"])
                           if "faults" in d else None),
                   verify=d.get("verify", False))

    @classmethod
    def from_json(cls, s: str) -> "Experiment":
        return cls.from_dict(json.loads(s))


@telemetry.spanned("experiment.run_experiments")
def run_experiments(exps: Sequence[Experiment]) -> list["Report"]:
    """Run many experiments, batching aggressively: experiments are
    grouped by topology spec (one geometry upload and one kernel launch
    each; mixed budgets group further inside ``sweep.sweep``), and results
    come back in input order."""
    groups: dict[TopologySpec, list[int]] = {}
    for i, e in enumerate(exps):
        groups.setdefault(e.topology, []).append(i)
    out: list[Optional[Report]] = [None] * len(exps)
    for spec_, idxs in groups.items():
        results = sweep.sweep(spec_.build(),
                              [exps[i].sim_config() for i in idxs])
        for i, r in zip(idxs, results):
            out[i] = _report(exps[i], r)
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# The unified report.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Report:
    """Joined result: simulation metrics + power (dynamic term scaled by
    the measured activity factor) + area + analytic bounds, with the
    experiment spec that produced them."""

    experiment: Experiment
    sim: sim.SimResult
    power: power.PowerReport
    area: area.AreaReport
    analytic: AnalyticBounds

    def row(self) -> dict:
        """One flat dict joining the headline columns of every surface."""
        return {**self.sim.row(),
                "total_w": round(self.power.total_w, 3),
                "lut": self.area.lut,
                "diameter": self.analytic.diameter,
                "bisection_links": self.analytic.bisection_links}

    # -- resilience views (DESIGN.md §13) ----------------------------------
    @property
    def reachability(self) -> float:
        """Fraction of (src, dst) PE pairs with a live route (1.0 on a
        healthy fabric; < 1.0 when faults partition it)."""
        return self.sim.reachability

    @property
    def delivered_fraction(self) -> float:
        """delivered / offered over the measured window."""
        return self.sim.delivered_fraction

    def latency_inflation(self, healthy: "Report") -> float:
        """Average-latency ratio of this (faulted / repaired) run against
        a healthy baseline report of the same scenario; NaN when the
        baseline delivered nothing."""
        base = healthy.sim.avg_latency
        return (self.sim.avg_latency / base) if base > 0 else float("nan")

    # -- trace replay views (DESIGN.md §12) --------------------------------
    @property
    def completion_cycles(self) -> int:
        """Cycles to drain a trace workload end to end (-1 when the
        budget ran out, or for statistical traffic)."""
        return self.sim.completion_cycles

    @property
    def phase_latencies(self) -> tuple[int, ...]:
        """Per-phase cycle cost of a trace replay (empty when the traffic
        is statistical)."""
        return self.sim.phase_latencies()

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"experiment": self.experiment.to_dict(),
                "sim": _sim_result_to_dict(self.sim),
                "power": dataclasses.asdict(self.power),
                "area": dataclasses.asdict(self.area),
                "analytic": self.analytic.to_dict()}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "Report":
        return cls(experiment=Experiment.from_dict(d["experiment"]),
                   sim=_sim_result_from_dict(d["sim"]),
                   power=power.PowerReport(**d["power"]),
                   area=area.AreaReport(**d["area"]),
                   analytic=AnalyticBounds.from_dict(d["analytic"]))

    @classmethod
    def from_json(cls, s: str) -> "Report":
        return cls.from_dict(json.loads(s))


@telemetry.spanned("experiment.report")
def _report(exp: Experiment, r: sim.SimResult) -> Report:
    activity = power.activity_from_sim(r.flit_hops_per_cycle,
                                       exp.topology.n_pes)
    topo = exp.topology.build()
    return Report(experiment=exp, sim=r,
                  power=power.power(topo, activity),
                  area=area.area(topo),
                  analytic=_bounds(exp.topology))


def _sim_config_to_dict(cfg: sim.SimConfig) -> dict:
    pattern = (cfg.pattern if isinstance(cfg.pattern, str)
               else cfg.pattern.to_dict())
    d = {"cycles": cfg.cycles, "warmup": cfg.warmup,
         "inj_rate": cfg.inj_rate, "pattern": pattern,
         "locality_ringlet": cfg.locality_ringlet,
         "locality_block": cfg.locality_block, "seed": cfg.seed,
         "starvation_limit": cfg.starvation_limit,
         "backend": cfg.backend}
    if cfg.faults is not None:
        d["faults"] = cfg.faults.to_dict()
    if cfg.strict_barrier:
        d["strict_barrier"] = True
    if cfg.watchdog:
        d["watchdog"] = cfg.watchdog
    return d


def _sim_config_from_dict(d: dict) -> sim.SimConfig:
    d = dict(d)
    if not isinstance(d["pattern"], str):
        d["pattern"] = traffic.TrafficSpec.from_dict(d["pattern"])
    if "faults" in d:
        d["faults"] = FaultSpec.from_dict(d["faults"])
    return sim.SimConfig(**d)


def _sim_result_to_dict(r: sim.SimResult) -> dict:
    d = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    d["cfg"] = _sim_config_to_dict(r.cfg)
    return d


def _sim_result_from_dict(d: dict) -> sim.SimResult:
    d = dict(d)
    d["cfg"] = _sim_config_from_dict(d["cfg"])
    d["phase_done"] = tuple(d.get("phase_done", ()))  # JSON lists -> tuple
    return sim.SimResult(**d)
