"""Run one cell of the benchmark and print its result as the last line.

    python3 noc_bench/run.py --workload ring_mesh-1024.paper_grid \\
        --seed 7 --seconds 10 --trace 0

Run it from the root of a checkout on a machine with a CUDA card.  It
exits with a code other than 0, and prints no result, where there is no
card or fewer than the cell asks for, or where JAX or the reference
package was loaded.  Build and compile caches stay under ``build/``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for sub in ("build/torch_extensions", "build/triton_cache"):
    os.makedirs(os.path.join(ROOT, sub), exist_ok=True)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
# One process with one host thread of math: idle pool threads spinning on
# the host's shared cores made the host-bound requests spread by +-15 %.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from noc_bench import harness

    torch.set_num_threads(1)

    wl, _ = harness.cell(harness.manifest(), args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    line = harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the reference package: {found}",
              file=sys.stderr)
        return 4
    for name, v in line["check"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
