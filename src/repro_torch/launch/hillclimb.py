"""The hillclimb driver (the port of ``repro.launch.hillclimb``):
hypothesis -> change -> count -> compare, on the dry run.

Three cells (the paper-representative training cell, the worst roofline
fraction, the pod boundary's bytes) are run again under controlled
variants; every record lands in ``experiments/hillclimb_torch/`` as JSON.
Its numbers are the dry run's: counts and data-sheet predictions, not
measurements.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell train
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell decode
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell collective
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os

import torch

from repro_torch.launch import dryrun

OUT = "experiments/hillclimb_torch"


def record(name: str, rec: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] == "ok":
        r = rec["roofline"]
        mem = rec.get("memory", {})
        print(f"[{name}] dom={r['dominant']} bound={r['bound_s']:.3e}s "
              f"compute={r['compute_s']:.3e} memory={r['memory_s']:.3e} "
              f"collective={r['collective_s']:.3e} "
              f"temp={mem.get('temp_size_in_bytes', 0) / 2**30:.2f}GiB "
              f"frac={r['compute_s'] / max(r['bound_s'], 1e-30):.3f}",
              flush=True)
    else:
        print(f"[{name}] {rec['status']}: {rec.get('error', '')[:200]}",
              flush=True)
    return rec


def climb_train() -> None:
    """command-r-plus-104b/train_4k: the paper-representative cell
    (hierarchical traffic shaping of the heaviest training collectives)."""
    arch, shape = "command-r-plus-104b", "train_4k"
    # it0 = sweep baseline (act_shard=model_d, f32 FSDP gather, accum=8)
    record("train_it1_bf16_gather", dryrun.run_cell(
        arch, shape, False,
        cfg_overrides={"fsdp_gather_dtype": "bf16"}))
    record("train_it2_actshard_model_d", dryrun.run_cell(
        arch, shape, False,
        cfg_overrides={"act_shard": "model_d"}))
    record("train_it3_bf16_plus_seq", dryrun.run_cell(
        arch, shape, False,
        cfg_overrides={"fsdp_gather_dtype": "bf16",
                       "act_shard": "model_seq"}))


def climb_decode() -> None:
    """qwen2-7b/decode_32k: worst roofline fraction (cache streaming)."""
    arch, shape = "qwen2-7b", "decode_32k"
    record("decode_it1_seqshard_cache", dryrun.run_cell(
        arch, shape, False, attn_override="seq_shard"))
    # the reference names this record ``decode_it2_window1024``; its
    # override, kept here, is a window of 4 096
    record("decode_it2_window4096", dryrun.run_cell(
        arch, shape, False,
        cfg_overrides={"sliding_window": 4096}))


# the reference's collective cell: h2o-danube-1.8b, 64 x 512 tokens
COLLECTIVE_ARCH, COLLECTIVE_BATCH, COLLECTIVE_SEQ = "h2o-danube-1.8b", 64, 512


def collective_census(schedule: str, *, compress: bool = False) -> dict:
    """The collective census of one ``make_dp_grad_fn`` gradient on fake
    tensors over the multi-pod fake mesh (rank 0's process): the
    reference's collective cell, ``act_shard="none"``, no remat, the plain
    route."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.dist import context, data_parallel
    from repro_torch.launch import census as census_mod
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    device = dryrun.fake_device()
    cfg = dataclasses.replace(configs.get(COLLECTIVE_ARCH), act_shard="none",
                              remat=False, attn_impl="torch")
    mesh = mesh_mod.make_fake_mesh(True, device=device)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = M.L.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
                M.abstract_params(cfg))
            batch = {k: torch.zeros((COLLECTIVE_BATCH, COLLECTIVE_SEQ),
                                    dtype=torch.int32, device=device)
                     for k in ("tokens", "labels")}
            fn = data_parallel.make_dp_grad_fn(
                functools.partial(M.loss_fn, cfg), mesh, schedule=schedule,
                compress=compress)
            with context.use_mesh(mesh), census_mod.Census() as c:
                loss, grads = fn(params, batch)
                del loss, grads
        return c.collectives()
    finally:
        mesh_mod.destroy_fake_mesh()


def climb_collective(out: str = OUT) -> dict:
    """Pod-boundary bytes: flat psum vs hierarchical ring-mesh reduce vs
    int8-compressed pod hop (the paper's schedule), counted by the
    census beside the reference's HLO census
    (``experiments/hillclimb/collective_schedules.json``)."""
    result = {}
    for name, kw in (("flat", dict(schedule="flat")),
                     ("hier", dict(schedule="hier")),
                     ("hier_int8", dict(schedule="hier", compress=True))):
        coll = collective_census(**kw)
        result[name] = coll
        print(f"[collective/{name}] total="
              f"{coll['total_bytes'] / 2**30:.2f}GiB "
              f"mix={coll['bytes_by_kind']}", flush=True)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "collective_schedules.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cell", choices=["train", "decode", "collective",
                                      "all"], default="all")
    args = p.parse_args()
    if args.cell in ("train", "all"):
        climb_train()
    if args.cell in ("decode", "all"):
        climb_decode()
    if args.cell in ("collective", "all"):
        climb_collective()


if __name__ == "__main__":
    main()
