"""Write ``tests/data/torch_port_trace_fault_reference.json`` from the JAX
package.

The PyTorch port (``src/repro_torch``) must reproduce the reference
simulator's trace replay and runtime fault injection bit for bit.  This
script runs three recipes through the reference's ``Experiment`` API on
the CPU (``backend="xla"``, the ``lax.scan`` oracle) and records every
``SimResult`` field of each point — ``phase_done``, ``reachability`` and
``stall_unretired`` included — with the jax version:

* ``trace_replay``: the recipe of ``benchmarks/trace_replay.py`` — the
  three mined schedules of ``experiments/hillclimb/collective_schedules.json``
  (``traces_for_schedules(n, pod_size=16, algorithm="halving_doubling",
  normalize_flits=8)``) on both families at 64, 256 and 1024 PEs,
  ``src_queue_depth=8``, ``Budget(cycles={64: 1200, 256: 2000,
  1024: 4000}, warmup=0)``, injection rate 1.0, seed 1;
* ``fault_tolerance``: the recipe of ``benchmarks/fault_sweep.py`` at 64,
  256 and 1024 PEs — per family and size the healthy point, dead-link
  counts (2, 4, 8) x fault seeds (0, 1) injected unrepaired, and the
  repaired twin of the 4-link seed-0 scenario, uniform traffic below
  saturation, ``warmup=0``;
* ``watchdog``: ``benchmarks/fault_sweep.watchdog_demo`` at 16 PEs, strict
  barriers with a 64-cycle watchdog and lenient barriers.

Trace replay runs at injection rate 1.0, so its Bernoulli draws are all
true and its results do not depend on the random stream; the fault points
do, and hold for the jax version recorded here.  ``chip_smoke.py`` holds
the CUDA kernel to the 256- and 1024-PE points on the card;
``tests/test_torch_trace.py`` and ``tests/test_torch_faults.py`` hold the
plain twin to some 64- and 16-PE points on the CPU.

Run once, from the repo root (a few minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tests/make_torch_port_trace_fault_reference.py
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax

from repro import trace as tr
from repro.core.experiment import Budget, Experiment, run_experiments
from repro.core.spec import TopologySpec
from repro.faults import FaultSpec, sample_faults, suggest_repair_morph

SIZES = (64, 256, 1024)
FAMILIES = ("ring_mesh", "flat_mesh")
SRC_QUEUE_DEPTH = 8
TRACE = dict(pod_size=16, algorithm="halving_doubling", normalize_flits=8,
             cycles={64: 1200, 256: 2000, 1024: 4000}, inj_rate=1.0,
             seed=1)
FAULT = dict(cycles={64: 800, 256: 1000, 1024: 1200},
             inj_rate={64: 0.1, 256: 0.04, 1024: 0.02},
             counts=(2, 4, 8), seeds=(0, 1), repair_count=4, seed=0)
WATCHDOG = dict(n_pes=16, watchdog=64, cycles=800,
                phases=[[[0, 1, 4], [2, 3, 4]], [[0, 8, 4]]],
                dead_routers=[0])
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_trace_fault_reference.json")


def _spec(family: str, n: int) -> TopologySpec:
    return TopologySpec(family, n, src_queue_depth=SRC_QUEUE_DEPTH)


def _fields(r) -> dict:
    d = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
         if f.name != "cfg"}
    d["phase_done"] = list(d["phase_done"])
    return d


def trace_points() -> list[dict]:
    points = []
    for n in SIZES:
        traces = tr.traces_for_schedules(
            n, pod_size=TRACE["pod_size"], algorithm=TRACE["algorithm"],
            normalize_flits=TRACE["normalize_flits"])
        budget = Budget(cycles=TRACE["cycles"][n], warmup=0)
        for fam in FAMILIES:
            exp = Experiment(topology=_spec(fam, n),
                             traffic=next(iter(traces.values())),
                             budget=budget, inj_rate=TRACE["inj_rate"],
                             seed=TRACE["seed"])
            reports = exp.run_grid(traffics=tuple(traces.values()))
            for sched, rep in zip(traces, reports):
                points.append({"family": fam, "n_pes": n,
                               "schedule": sched, **_fields(rep.sim)})
    return points


def fault_experiments(sizes=SIZES):
    """(tags, experiments) of the fault recipe, in table order."""
    exps, tags = [], []
    for n in sizes:
        budget = Budget(cycles=FAULT["cycles"][n], warmup=0)
        inj = FAULT["inj_rate"][n]
        for fam in FAMILIES:
            spec = _spec(fam, n)
            topo = spec.build()
            scen = {(c, s): sample_faults(topo, n_dead_links=c, seed=s)
                    for c in FAULT["counts"] for s in FAULT["seeds"]}
            exps.append(Experiment(topology=spec, budget=budget,
                                   inj_rate=inj, seed=FAULT["seed"]))
            tags.append((fam, n, "healthy", 0, 0, None))
            for (c, s), f in scen.items():
                exps.append(Experiment(topology=spec, budget=budget,
                                       inj_rate=inj, seed=FAULT["seed"],
                                       faults=f))
                tags.append((fam, n, "faulted", c, s, f))
            rc, rs = FAULT["repair_count"], FAULT["seeds"][0]
            exps.append(Experiment(
                topology=suggest_repair_morph(spec, scen[(rc, rs)]),
                budget=budget, inj_rate=inj, seed=FAULT["seed"]))
            tags.append((fam, n, "repaired", rc, rs, scen[(rc, rs)]))
    return tags, exps


def fault_points() -> list[dict]:
    tags, exps = fault_experiments()
    points = []
    for (fam, n, mode, c, s, f), rep in zip(tags, run_experiments(exps)):
        points.append({"family": fam, "n_pes": n, "mode": mode,
                       "n_dead_links": c, "fault_seed": s,
                       "faults": f.to_dict() if f else None,
                       **_fields(rep.sim)})
    return points


def watchdog_points() -> list[dict]:
    n = WATCHDOG["n_pes"]
    trace = tr.from_records(n, WATCHDOG["phases"])
    faults = FaultSpec(dead_routers=tuple(WATCHDOG["dead_routers"]))
    points = []
    for mode, strict, wd in (("strict", True, WATCHDOG["watchdog"]),
                             ("lenient", False, 0)):
        rep = Experiment(
            topology=_spec("ring_mesh", n), traffic=trace,
            budget=Budget(cycles=WATCHDOG["cycles"], warmup=0,
                          strict_barrier=strict, watchdog=wd),
            inj_rate=1.0, faults=faults).run()
        points.append({"mode": mode, **_fields(rep.sim)})
    return points


def main() -> None:
    doc = {"jax_version": jax.__version__,
           "recipes": {"src_queue_depth": SRC_QUEUE_DEPTH,
                       "trace_replay": {**TRACE, "sizes": list(SIZES)},
                       "fault_tolerance": {**FAULT, "sizes": list(SIZES)},
                       "watchdog": WATCHDOG},
           "trace_replay": trace_points(),
           "fault_tolerance": fault_points(),
           "watchdog": watchdog_points()}
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    for p in doc["watchdog"]:
        print(p["mode"], p["phase_done"], p["stall_unretired"],
              p["dropped"])


if __name__ == "__main__":
    main()
