"""Multi-pod dry run (the port of ``repro.launch.dryrun``): run every
(architecture x input shape) cell's step once on fake tensors over the
production meshes and record memory / cost / collective data.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out experiments/dryrun_torch

Every record lands in ``<out>/<arch>__<shape>__<mesh>.json`` so partial
sweeps resume for free (``--force`` recomputes).  Nothing runs on a
card: each cell brings up PyTorch's simulated world of 256 or 512 ranks
in this process (``mesh.make_fake_mesh``, rank 0 standing for every
rank), builds its case (``steps.make_case``: fake DTensors whose local
shards are the per-device shapes) and runs the step once under a
``census.Census``.  The fake tensors name the card's device, ``cuda``,
where PyTorch has CUDA, and ``cpu`` otherwise (a CPU-only PyTorch cannot
carry fake CUDA tensors through its autograd engine); shapes, dtypes and
so every count are the same either way.

The record keeps the reference's keys where they have a counterpart:
``memory`` (``argument_size_in_bytes``: the arguments' local shards;
``output_size_in_bytes``: the outputs'; ``temp_size_in_bytes``: the
census's peak above the arguments), ``flops`` / ``bytes_accessed`` (per
device, the census's), ``collectives`` (``launch.hlo``'s keys),
``probes`` and ``roofline``.  ``run_s`` is the fake run's seconds.
Dropped, having none: ``compile_s`` (nothing is compiled), ``fusions``
(eager ops are not fused) and ``generated_code_size_in_bytes``.

The roofline's constants are NVIDIA's H100 SXM data sheet figures, not
measurements: 989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3 and 450e9 B/s
per NVLink direction (the same numbers ``chip_smoke.py`` bounds its
kernels with).  A roofline term is a prediction, never a time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.dist import context
from repro_torch.launch import census as census_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shapes as shp
from repro_torch.launch import steps as steps_mod

# NVIDIA H100 SXM data sheet constants (roofline; not measurements)
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s per card
HBM_BW = 3.35e12           # bytes/s per card (HBM3)
LINK_BW = 450e9            # bytes/s per NVLink direction


def fake_device() -> str:
    """The device the fake tensors name: the card's where PyTorch has
    CUDA, else the CPU (see the module docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (a Python int
    counts as the reference's int32 scalar)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, int):
        return 4
    return 0


def run_case(case, mesh) -> tuple[dict, float]:
    """Run ``case``'s step once under a census, in its fake mode (if any)
    with the mesh ambient and plain tensors read as replicated.  Returns
    (the census's summary with ``memory``, seconds)."""
    import contextlib
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    with case.mode if case.mode is not None else contextlib.nullcontext(), \
            context.use_mesh(mesh), implicit_replication(), \
            census_mod.Census() as c:
        out = case.fn(*case.args)
        out_bytes = local_bytes(out)
        del out
    rec = c.summary()
    rec["memory"] = {"argument_size_in_bytes": local_bytes(case.args),
                     "output_size_in_bytes": out_bytes,
                     "temp_size_in_bytes": rec.pop("peak_bytes")}
    rec["op_census"] = c.op_census()
    return rec, time.time() - t0


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             rules=None, attn_override=None, extra_tag: str = "",
             cfg_overrides: dict | None = None, device: str | None = None,
             mesh_shape=None, cell=None, cfg=None) -> dict:
    """One cell's record (see the module docstring).  ``mesh_shape`` /
    ``cell`` / ``cfg`` replace the production mesh ((shape, axes)), the
    cell and the configuration (tests: smoke sizes)."""
    cfg = cfg or configs.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = cell or shp.make_cell(arch, shape)
    rec: dict = {
        "arch": arch, "shape": shape,
        "mesh": "multi" if multi_pod else "single",
        "kind": cell.kind, "seq_len": cell.seq_len,
        "global_batch": cell.global_batch, "tag": extra_tag,
    }
    ok, why = shp.cell_supported(arch, shape)
    if not ok:
        rec.update(chips=512 if multi_pod else 256, status="skipped",
                   reason=why)
        return rec
    device = device or fake_device()
    shape_axes = mesh_shape or (None, None)
    try:
        mesh = mesh_mod.make_fake_mesh(multi_pod, device=device,
                                       shape=shape_axes[0],
                                       axes=shape_axes[1])
        rec["chips"] = mesh.size
        case = steps_mod.make_case(cfg, cell, mesh, rules=rules,
                                   attn_override=attn_override,
                                   device=device)
        main, secs = run_case(case, mesh)
        rec.update(status="ok", run_s=round(secs, 1),
                   memory=main["memory"], flops_raw=main["flops"],
                   bytes_accessed_raw=main["bytes_accessed"],
                   collectives=main["collectives"],
                   op_census=main["op_census"], accum_steps=case.accum)
        from repro_torch.launch import probe as probe_mod
        with case.mode:
            corr = probe_mod.corrected_costs(
                case.cfg, cell, mesh,
                {"flops": main["flops"],
                 "bytes_accessed": main["bytes_accessed"],
                 "collective_bytes": main["collectives"]["total_bytes"]},
                accum=case.accum, device=device)
        rec["flops"] = corr["corrected"]["flops"]
        rec["bytes_accessed"] = corr["corrected"]["bytes_accessed"]
        rec["collective_bytes"] = corr["corrected"]["collective_bytes"]
        rec["probes"] = corr["probes"]
        rec["roofline"] = roofline_terms(rec, cfg)
    except Exception as e:  # noqa: BLE001 — report, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    finally:
        mesh_mod.destroy_fake_mesh()
    return rec


def roofline_terms(rec: dict, cfg) -> dict:
    """Seconds each resource would take at the data sheet's peak
    (predictions): flops / PEAK_FLOPS, bytes / HBM_BW, collective bytes /
    LINK_BW, all per device; the largest is the bound."""
    chips = rec["chips"]
    flops = rec.get("flops", rec.get("flops_raw", 0.0))
    byts = rec.get("bytes_accessed", rec.get("bytes_accessed_raw", 0.0))
    coll = rec.get("collective_bytes",
                   rec.get("collectives", {}).get("total_bytes", 0))
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = coll / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    tokens = rec["global_batch"] * (rec["seq_len"]
                                    if rec["kind"] != "decode" else 1)
    model_flops = cfg.model_flops_per_token(
        train=rec["kind"] == "train") * tokens
    terms.update(
        dominant=dom,
        model_flops=model_flops,
        hlo_flops_total=flops * chips,
        useful_flops_ratio=(model_flops / (flops * chips)
                            if flops else 0.0),
        bound_s=max(compute_s, memory_s, collective_s),
    )
    return terms


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="both",
                   choices=["single", "multi", "both"])
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--force", action="store_true")
    p.add_argument("--tag", default="")
    args = p.parse_args()

    archs = configs.all_archs() if args.arch == "all" else [args.arch]
    shapes_list = list(shp.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes_list:
            for multi in meshes:
                tagpart = f"__{args.tag}" if args.tag else ""
                fname = os.path.join(
                    args.out,
                    f"{arch}__{shape}__{'multi' if multi else 'single'}"
                    f"{tagpart}.json")
                if os.path.exists(fname) and not args.force:
                    with open(fname) as f:
                        rec = json.load(f)
                    print(f"[cached] {fname}: {rec['status']}")
                    results.append(rec)
                    continue
                rec = run_cell(arch, shape, multi, extra_tag=args.tag)
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    mem = rec["memory"]
                    extra = (f" run={rec['run_s']}s "
                             f"dom={r['dominant']} "
                             f"bound={r['bound_s']:.3e}s "
                             f"flops={rec['flops']:.3e}"
                             f" temp/dev="
                             f"{mem['temp_size_in_bytes'] / 2**30:.2f}GiB"
                             f" args/dev="
                             f"{mem['argument_size_in_bytes'] / 2**30:.2f}"
                             f"GiB")
                elif status == "error":
                    extra = " " + rec["error"][:160]
                print(f"[{status}] {arch}/{shape}/"
                      f"{'multi' if multi else 'single'}{extra}", flush=True)
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)} cells")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
