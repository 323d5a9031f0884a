"""Write ``tests/data/torch_port_fabric_reference.json`` from the JAX package.

The reference certificates of the port's fabric analysis
(``repro_torch.analysis.fabric``), computed by ``repro.analysis.fabric``
on the CPU (no simulation: the walks take a few seconds at 1024 PEs).
Each entry is a certificate's ``to_dict()`` without ``elapsed_ms``, its
``spec`` the ``TopologySpec.to_dict()`` that rebuilds the fabric:

* ``config`` / ``morph`` / ``repair`` — every target of
  ``_config_targets(max_pes=1024, with_morphs=True, with_repairs=True)``:
  the NoC config's fabrics at 16-1024 PEs of both families, two morph
  overlays and two repaired fabrics at 64 PEs;
* ``fault_recipe_repair`` — the repaired fabric of the fault recipe's
  repair scenario (``recipes.fault_tolerance`` of
  ``tests/data/torch_port_trace_fault_reference.json``: ``repair_count``
  dead links from ``sample_faults`` at ``seeds[0]``, ``src_queue_depth``
  8) at 64, 256 and 1024 PEs of both families — the fabric whose
  certificate ``measure_repair`` reports;
* ``bfs_refill_cycle`` — flat_mesh 64 with 4 dead links from
  ``sample_faults`` seed 3, a BFS refill that re-introduces a dependency
  cycle: the certificate is a rejection with its queue-cycle witness.

``chip_smoke.py`` (phase 12) certifies every fabric here on the card and
holds each certificate to this file; ``tests/test_torch_analysis.py``
does so on the CPU at the sizes a CPU run affords.

Run once, from the repo root (~15 s on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_port_fabric_reference.py
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax

from repro.analysis import fabric
from repro.core.spec import TopologySpec
from repro.faults import sample_faults, suggest_repair_morph

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
OUT = os.path.join(DATA, "torch_port_fabric_reference.json")
TRACE_FAULT_REFERENCE = os.path.join(
    DATA, "torch_port_trace_fault_reference.json")
FAULT_SIZES = (64, 256, 1024)
BFS_REFILL = {"family": "flat_mesh", "n_pes": 64, "n_dead_links": 4,
              "seed": 3}


def entry(label: str, spec: TopologySpec) -> dict:
    cert = fabric.certify(spec, use_cache=False).to_dict()
    del cert["elapsed_ms"]
    return {"label": label, "certificate": cert}


def recipe_repairs(recipe: dict, depth: int):
    """(family, n, repaired spec) of the fault recipe's repair scenario."""
    for n in FAULT_SIZES:
        for fam in ("ring_mesh", "flat_mesh"):
            spec = TopologySpec(fam, n, src_queue_depth=depth)
            flt = sample_faults(spec.build(),
                                n_dead_links=recipe["repair_count"],
                                seed=recipe["seeds"][0])
            yield suggest_repair_morph(spec, flt)


def main() -> None:
    with open(TRACE_FAULT_REFERENCE) as f:
        recipes = json.load(f)["recipes"]
    recipe = recipes["fault_tolerance"]
    entries = [entry(label, spec)
               for label, spec in fabric._config_targets(1024, True, True)]
    entries += [entry("fault_recipe_repair", spec)
                for spec in recipe_repairs(recipe,
                                           recipes["src_queue_depth"])]
    base = TopologySpec(BFS_REFILL["family"], BFS_REFILL["n_pes"])
    flt = sample_faults(base.build(), n_dead_links=BFS_REFILL["n_dead_links"],
                        seed=BFS_REFILL["seed"])
    entries.append(entry("bfs_refill_cycle",
                         dataclasses.replace(base, faults=flt)))
    out = {"jax_version": jax.__version__,
           "recipe": {"config_targets": {"max_pes": 1024, "morphs": True,
                                         "repairs": True},
                      "fault_recipe_repair": {
                          "sizes": list(FAULT_SIZES),
                          "src_queue_depth": recipes["src_queue_depth"],
                          "n_dead_links": recipe["repair_count"],
                          "seed": recipe["seeds"][0]},
                      "bfs_refill_cycle": BFS_REFILL},
           "certificates": entries}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {len(entries)} certificates to {OUT}")


if __name__ == "__main__":
    main()
