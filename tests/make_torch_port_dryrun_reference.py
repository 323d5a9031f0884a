"""Write ``tests/data/torch_port_dryrun_reference.json`` from the JAX package.

The reference for the port's dry run (``tests/test_torch_launch.py``):
the reference's ``make_case`` lowered and compiled on a (2, 2, 2)
``("pod", "data", "model")`` mesh of 8 forced host devices, at the smoke
size of its own ``tests/test_launch.py::test_mini_dryrun_compiles_and_
reports`` (qwen2-7b ``train_4k`` and ``decode_32k`` cut to 8 sequences
of 64), plus one smoke cell of mamba2-1.3b (``prefill_32k``) and of
whisper-small (``train_4k``) at the same cut.  Per cell: the compiled
module's ``memory_analysis`` (argument, output and temp bytes per
device), its per-device FLOPs and bytes accessed corrected for scan
bodies as ``repro.launch.dryrun.run_cell`` corrects them
(``probe.corrected_costs``), and the collective census of its HLO
(``hlo.collective_bytes``: per-device operand bytes by kind).

Run once, from the repo root (about 2 minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_port_dryrun_reference.py
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import json  # noqa: E402

from repro import configs  # noqa: E402
from repro.dist import context  # noqa: E402
from repro.launch import hlo, probe, shapes, steps  # noqa: E402
from repro.launch import mesh as mesh_mod  # noqa: E402
from repro.models import smoke_config  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_dryrun_reference.json")
MESH = ((2, 2, 2), ("pod", "data", "model"))
SEQ, BATCH = 64, 8
CELLS = (("qwen2-7b", "train_4k"), ("qwen2-7b", "decode_32k"),
         ("mamba2-1.3b", "prefill_32k"), ("whisper-small", "train_4k"))


def run(arch: str, shape: str, mesh) -> dict:
    cfg = smoke_config(configs.get(arch))
    cell = dataclasses.replace(shapes.make_cell(arch, shape),
                               seq_len=SEQ, global_batch=BATCH)
    with context.use_mesh(mesh):
        case = steps.make_case(cfg, cell, mesh)
        compiled = case.fn.lower(*case.args).compile()
        mem = compiled.memory_analysis()
        cost = compiled.cost_analysis()
        coll = hlo.collective_bytes(compiled.as_text())
        corr = probe.corrected_costs(
            case.cfg, cell, mesh,
            {"flops": float(cost.get("flops", 0.0)),
             "bytes_accessed": float(cost.get("bytes accessed", 0.0)),
             "collective_bytes": coll["total_bytes"]},
            accum=case.accum)
    return {
        "arch": arch, "shape": shape, "kind": cell.kind,
        "seq_len": SEQ, "global_batch": BATCH, "accum_steps": case.accum,
        "memory": {k: int(getattr(mem, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes")},
        "flops_raw": float(cost.get("flops", 0.0)),
        "flops": corr["corrected"]["flops"],
        "bytes_accessed": corr["corrected"]["bytes_accessed"],
        "collectives": coll,
    }


def main() -> None:
    mesh = mesh_mod.make_dev_mesh(*MESH)
    out = {"mesh": {"shape": list(MESH[0]), "axes": list(MESH[1])},
           "cells": [run(a, s, mesh) for a, s in CELLS]}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    for c in out["cells"]:
        print(c["arch"], c["shape"], c["memory"], c["flops"],
              c["collectives"]["bytes_by_kind"])


if __name__ == "__main__":
    main()
