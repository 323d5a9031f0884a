"""Tables of the dry run's records (the port of ``repro.launch.report``):
the records, the single-pod roofline and a summary.

    PYTHONPATH=src python -m repro_torch.launch.report \\
        --dir experiments/dryrun_torch

Every time in them is a prediction from NVIDIA's H100 SXM data sheet
constants (``dryrun.PEAK_FLOPS`` / ``HBM_BW`` / ``LINK_BW``), never a
measurement.  The temp column is one number: the fake tensors hold the
card's own dtypes, so there is no CPU legalization to discount (the
reference's ``CPU_LEGALIZATION_FACTOR``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

HBM_PER_CHIP = 80e9  # H100 SXM, data sheet


def load(dirname: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | run_s | args GiB/dev | "
        "temp GiB/dev | fits 80 GB | GFLOP/dev | coll GiB/dev | "
        "collective mix |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP | - | - "
                f"| - | - | - | - | {r['reason'][:60]} |")
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | - | "
                f"- | - | - | - | - | {r.get('error', '')[:60]} |")
            continue
        mem = r.get("memory", {})
        temp = mem.get("temp_size_in_bytes", 0)
        args = mem.get("argument_size_in_bytes", 0)
        coll = r.get("collective_bytes", 0)
        mix = r.get("collectives", {}).get("count_by_kind", {})
        mix_s = " ".join(f"{k.split('-')[-1][:4]}:{v}"
                         for k, v in sorted(mix.items()))
        fits = "yes" if args + temp <= HBM_PER_CHIP else "no"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['run_s']} | {fmt_bytes(args)} | {fmt_bytes(temp)} | {fits} "
            f"| {r['flops'] / 1e9:.0f} | {fmt_bytes(coll)} | {mix_s} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL_FLOPS | FLOPs (total) | useful ratio | "
        "compute/bound (\"roofline fraction\") | what moves the bottleneck |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        t = r["roofline"]
        frac = t["compute_s"] / max(t["bound_s"], 1e-30)
        note = bottleneck_note(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"{t['dominant'].replace('_s', '')} | "
            f"{t['model_flops']:.2e} | {t['hlo_flops_total']:.2e} | "
            f"{t['useful_flops_ratio']:.2f} | {frac:.2f} | {note} |")
    return "\n".join(lines)


def bottleneck_note(r: dict) -> str:
    dom = r["roofline"]["dominant"]
    kind = r["kind"]
    if dom == "memory_s":
        if kind == "decode":
            return ("KV cache streaming: attention's float32 reads of the "
                    "cache (written in place); a split-K decode attention "
                    "kernel (csrc/flash_attention.cu)")
        return ("activation traffic of eager ops: flash_attention / "
                "ssd_scan (csrc/*.cu) on the kernel route, fusion of the "
                "norms and casts")
    if dom == "collective_s":
        kinds = r.get("collectives", {}).get("bytes_by_kind", {})
        if kinds and max(kinds, key=kinds.get) == "collective-permute":
            return ("the decode ring's chunks (dist.decode_attn, sent in "
                    "float32): send the cache's own bf16 rows")
        return ("FSDP gathers and Megatron reductions: the hier / int8 "
                "schedules of dist.collectives, a bf16 gather "
                "(fsdp_gather_dtype)")
    return "compute-bound: at roofline, only kernel-level wins remain"


def summary(recs: list[dict]) -> str:
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    n_err = len(recs) - n_ok - n_skip
    worst = [(r["roofline"]["compute_s"] / max(r["roofline"]["bound_s"],
                                               1e-30), r)
             for r in recs if r["status"] == "ok"
             and r.get("mesh") == "single"]
    worst.sort(key=lambda x: x[0])
    lines = [f"{n_ok} ok / {n_skip} skipped / {n_err} errors "
             f"over {len(recs)} records", ""]
    if worst:
        lines.append("Worst roofline fractions (hillclimb candidates):")
        for frac, r in worst[:5]:
            lines.append(f"  - {r['arch']}/{r['shape']}: {frac:.3f} "
                         f"(dominant {r['roofline']['dominant']})")
        coll = [(r["roofline"]["collective_s"] /
                 max(r["roofline"]["bound_s"], 1e-30), r)
                for _, r in worst]
        coll.sort(key=lambda x: -x[0])
        lines.append("Most collective-bound:")
        for frac, r in coll[:3]:
            lines.append(f"  - {r['arch']}/{r['shape']}: collective share "
                         f"{frac:.2f}")
    return "\n".join(lines)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="experiments/dryrun_torch")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    recs = load(args.dir)
    txt = []
    txt.append("## Dry-run records (predictions; H100 data sheet)\n")
    txt.append(dryrun_table(recs))
    txt.append("\n## Roofline (single-pod 16x16; predictions)\n")
    txt.append(roofline_table(recs, "single"))
    txt.append("\n## Summary\n")
    txt.append(summary(recs))
    out = "\n".join(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    else:
        print(out)


if __name__ == "__main__":
    main()
