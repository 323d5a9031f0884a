"""The control of the comparison that decides ``correct``, read on the card
at a cell's own size: the plain reference in the program's place, its
float32 draws and thresholds rounded to bfloat16 (the step below what the
configuration states), against the reference in float32.  Each seed's
first ``--requests`` requests (one by default); one JSON line a request
with the check's numbers.

    python3 noc_bench/control.py --workload ring_mesh-1024.paper_grid \\
        --seeds 11 12 13

The benchmark's own runs never run it.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from noc_bench import check, generator, harness

    wl, cfg_entry = harness.cell(harness.manifest(), args.workload)
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    mix = generator.load_json("traffic", wl["traffic"])
    entry = generator.entry(mix["entry"])
    context = entry.context(config, mix)
    for seed in args.seeds:
        gen = generator.Generator(config, mix, seed, context)
        for i in range(args.requests):
            req = gen.request(i)
            t = time.perf_counter()
            want = entry.reference(req, args.device)
            t_ref = time.perf_counter() - t
            got = entry.reference(req, args.device, "bfloat16")
            counts = dict(check.compare(got, want), requests_failed=0)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "request": i, "reference_s": round(t_ref, 3),
                              "correct": check.verdict(counts)["correct"],
                              **counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
