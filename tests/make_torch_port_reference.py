"""Write ``tests/data/torch_port_reference.json`` from the JAX package.

The PyTorch port (``src/repro_torch``) must reproduce the reference
simulator bit for bit.  This script runs the figs15_17 scalability recipe
of ``benchmarks/noc_tables.py`` (``src_queue_depth=8``, the paper's
locality regime, uniform / bit_reversal / transpose at injection rate
0.625, 900 cycles with 300 of warm-up, seed 1) through the reference's
``run_experiments`` on the CPU at 64, 256 and 1024 PEs for both families,
and records every ``SimResult`` field of each point, the figs15_17 rows
and the jax version.  ``tests/test_torch_sim.py`` holds the port to the
64-PE points on the CPU; ``chip_smoke.py`` holds the CUDA kernel to the
256- and 1024-PE points on the card.

Run once, from the repo root (it takes a few minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_port_reference.py
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np

from repro.configs.ringmesh_noc import CONFIG
from repro.core.experiment import run_experiments

SIZES = (64, 256, 1024)
FAMILIES = ("ring_mesh", "flat_mesh")
RECIPE = dict(injection_rates=(0.625,), cycles=900, warmup=300)
SEED = 1
RESULT_FIELDS = ("delivered", "offered", "accepted", "dropped", "lost",
                 "in_flight", "measured_cycles", "avg_latency", "throughput",
                 "flit_hops_per_cycle", "per_pe_throughput")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_reference.json")


def main() -> None:
    cfg = dataclasses.replace(CONFIG, **RECIPE)
    exps = cfg.experiments(sizes=SIZES, families=FAMILIES, seed=SEED)
    reports = run_experiments(exps)
    points = []
    for e, r in zip(exps, reports):
        points.append({"family": e.topology.family,
                       "n_pes": e.topology.n_pes,
                       "pattern": e.traffic.kind,
                       **{f: getattr(r.sim, f) for f in RESULT_FIELDS}})
    rows = []
    for n in SIZES:
        for fam in FAMILIES:
            pts = [p for p in points
                   if p["n_pes"] == n and p["family"] == fam]
            rows.append({"n_pes": n, "topology": fam,
                         "avg_latency": round(float(np.mean(
                             [p["avg_latency"] for p in pts])), 1),
                         "avg_throughput": round(float(np.mean(
                             [p["throughput"] for p in pts])), 1)})
    doc = {"jax_version": jax.__version__,
           "recipe": {**{k: list(v) if isinstance(v, tuple) else v
                         for k, v in RECIPE.items()},
                      "seed": SEED, "queue_depth": cfg.queue_depth,
                      "src_queue_depth": cfg.src_queue_depth,
                      "locality_ringlet": cfg.locality_ringlet,
                      "locality_block": cfg.locality_block,
                      "patterns": list(cfg.patterns)},
           "figs15_17_rows": rows,
           "points": points}
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
