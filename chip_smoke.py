"""Drive the PyTorch/CUDA port of the NoC simulator on one NVIDIA card.

    python3 chip_smoke.py

Runs from a checkout of the repository, needs one CUDA device and nvcc,
and imports nothing of jax or of the JAX reference package.  It builds the
port's CUDA kernel from ``src/repro_torch/kernels/csrc`` and runs four
phases; any failure raises and exits non-zero.

1. Device: the card's name and power limit (``nvidia-smi``), the kernel's
   build time and its register report.
2. Kernel vs plain twin on the card, bit for bit: ``SimResult`` and
   ``kind_diagnostics`` over the 16-PE matrix of both families, 64 PEs
   under the paper's locality, a morph overlay, a repaired fabric, one
   1024-PE point, a batched sweep against per-point runs, and the kernel's
   wrapper against the twin on the main path's own shapes.
3. The main path at full width: the figs15_17 recipe (src_queue_depth 8,
   the paper's locality, uniform / bit_reversal / transpose at injection
   rate 0.625, 900 cycles with 300 of warm-up, seed 1) at 256 and 1024
   PEs for both families through ``run_experiments`` on the CUDA backend,
   held field for field to ``tests/data/torch_port_reference.json`` (the
   JAX reference's results).  Launch counts are zeroed just before and
   read just after.
4. Times, with CUDA events after a warm-up: kernel ms per launch and us
   per cycle per point on the main path's shapes, the twin's time on the
   card, and the least time the card could take for the same work.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(ROOT, "tests", "data", "torch_port_reference.json")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/noc_step.cu"
REPLACES = "src/repro/kernels/noc_step.py:371"

# Published H100 SXM peaks (NVIDIA data sheet) used for the bound: device
# memory at 3.35 TB/s, and 67 T/s for scalar work outside the tensor
# cores (the data sheet's float32 rate; the kernel's work is int32 ALU).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

CARD = ""  # "name, power limit" as nvidia-smi reports them


def say(phase: int, msg: str) -> None:
    print(f"[phase {phase}] {msg}", flush=True)


def fields(r) -> dict:
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name != "cfg"}


def result_err(a, b) -> float:
    """Largest absolute difference over two results' numeric fields."""
    fa, fb = fields(a), fields(b)
    return max(abs(fa[k] - fb[k]) for k in fa
               if isinstance(fa[k], (int, float)))


# ---------------------------------------------------------------------------
def phase_device():
    global CARD
    from repro_torch.kernels import noc_step
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    say(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)} "
           f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    noc_step.load_library()
    say(1, f"noc_step kernel built and loaded in "
           f"{time.perf_counter() - t0:.3f} s")
    for line in noc_step.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(1, "ptxas: " + line.strip())


def phase_parity():
    """Kernel vs twin on the card.  Returns the largest difference seen."""
    from repro_torch.core import sim, sweep, topology
    from repro_torch.core.spec import MorphOverlay, TopologySpec
    from repro_torch.faults import sample_faults

    err = 0.0

    def both(topo, label, diag=True, **kw):
        nonlocal err
        a = sim.simulate(topo, sim.SimConfig(backend="cuda", **kw))
        b = sim.simulate(topo, sim.SimConfig(backend="torch", **kw))
        err = max(err, result_err(a, b))
        assert fields(a) == fields(b), (label, fields(a), fields(b))
        assert a.lost == 0, label
        if diag:
            da = sim.kind_diagnostics(topo, sim.SimConfig(backend="cuda",
                                                          **kw))
            db = sim.kind_diagnostics(topo, sim.SimConfig(backend="torch",
                                                          **kw))
            assert da == db, (label, da, db)
        say(2, f"{label}: kernel == twin (delivered {a.delivered}, "
               f"dropped {a.dropped}, in_flight {a.in_flight})")
        return a

    base = dict(cycles=300, warmup=100)
    for fam in ("ring_mesh", "flat_mesh"):
        t = TopologySpec(fam, 16).build()
        for rate, pat, seed in ((0.0, "uniform", 0), (0.25, "uniform", 1),
                                (0.9, "transpose", 2), (1.0, "hotspot", 3)):
            both(t, f"{fam}_16 {pat} {rate}", inj_rate=rate, pattern=pat,
                 seed=seed, **base)
        both(TopologySpec(fam, 64).build(), f"{fam}_64 paper locality",
             inj_rate=0.6, seed=7, **sim.PAPER_LOCALITY, **base)
    morph = TopologySpec("ring_mesh", 16, morphs=(MorphOverlay(
        hl=1, target=0, link_states=(0, 0, 0, 0, 2, 0, 0, 0)),))
    r = both(morph.build(), "ring_mesh_16 morph overlay", inj_rate=0.3,
             seed=4, **base)
    assert r.dropped > 0
    healthy = TopologySpec("flat_mesh", 64)
    repaired = dataclasses.replace(healthy, faults=sample_faults(
        healthy.build(), n_dead_links=3, seed=6))
    both(repaired.build(), "flat_mesh_64 repaired (3 dead links)",
         inj_rate=0.4, seed=5, **base)
    both(topology.build("ring_mesh", 1024), "ring_mesh_1024 paper locality",
         diag=False, inj_rate=0.625, seed=1, **sim.PAPER_LOCALITY, **base)

    t = TopologySpec("ring_mesh", 64).build()
    cfgs = sweep.grid(inj_rates=(0.25, 0.9), patterns=("uniform", "tornado"),
                      seeds=(0, 3), cycles=250, warmup=50, backend="cuda")
    batched = sweep.sweep(t, cfgs)
    for cfg, rb in zip(cfgs, batched):
        rp = sim.simulate(t, cfg)
        rt = sim.simulate(t, dataclasses.replace(cfg, backend="torch"))
        assert rb == rp and fields(rb) == fields(rt), cfg
        err = max(err, result_err(rb, rt))
    say(2, f"batched sweep of {len(cfgs)} points == per-point kernel runs "
           f"== twin")
    return err


def main_path_experiments():
    from repro_torch.configs.ringmesh_noc import CONFIG
    with open(REFERENCE) as f:
        ref = json.load(f)
    recipe = ref["recipe"]
    cfg = dataclasses.replace(
        CONFIG, injection_rates=tuple(recipe["injection_rates"]),
        cycles=recipe["cycles"], warmup=recipe["warmup"])
    return cfg.experiments(sizes=(256, 1024), seed=recipe["seed"]), ref


def main_path_groups(exps):
    """(topology, configs) of each geometry of the main path, as
    ``run_experiments`` groups them: one kernel launch each."""
    groups: dict = {}
    for e in exps:
        groups.setdefault(e.topology, []).append(e.sim_config())
    return [(spec.build(), cfgs) for spec, cfgs in groups.items()]


def phase_main_path():
    from repro_torch.core.experiment import run_experiments
    from repro_torch.kernels import noc_step

    exps, ref = main_path_experiments()
    want = {(p["family"], p["n_pes"], p["pattern"]): p
            for p in ref["points"]}
    noc_step.reset_launches()
    t0 = time.perf_counter()
    reports = run_experiments(exps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = noc_step.launches
    say(3, f"run_experiments: {len(exps)} points, {launches} noc_step "
           f"launches, {wall:.3f} s host wall clock incl. geometry and "
           f"stream setup [{CARD}]")
    assert launches > 0, "the main path never launched the kernel"
    for e, r in zip(exps, reports):
        p = want[(e.topology.family, e.topology.n_pes, e.traffic.kind)]
        got = {k: getattr(r.sim, k) for k in p
               if k not in ("family", "n_pes", "pattern")}
        exp = {k: v for k, v in p.items()
               if k not in ("family", "n_pes", "pattern")}
        # `lost` included: the reference's fixpoint leaves residue at
        # flat_mesh_1024 under bit_reversal/transpose, and so must the port.
        assert got == exp, (e.topology.name, e.traffic.kind, got, exp)
    say(3, f"all {len(reports)} SimResults equal the reference's "
           f"(jax {ref['jax_version']}) field for field")
    for n in sorted({r.experiment.topology.n_pes for r in reports}):
        for fam in ("ring_mesh", "flat_mesh"):
            rs = [r for r in reports if r.experiment.topology.n_pes == n
                  and r.experiment.topology.family == fam]
            lat = sum(r.sim.avg_latency for r in rs) / len(rs)
            thr = sum(r.sim.throughput for r in rs) / len(rs)
            row = {"n_pes": n, "topology": fam,
                   "avg_latency": round(lat, 1),
                   "avg_throughput": round(thr, 1)}
            assert row in ref["figs15_17_rows"], row
            r0 = rs[0]
            say(3, f"figs15_17 {json.dumps(row)} | power "
                   f"{r0.power.total_w:.3f} W (activity "
                   f"{r0.power.activity:.4f}, {r0.experiment.traffic.kind})"
                   f" | area {r0.area.lut} LUT | diameter "
                   f"{r0.analytic.diameter}")
    return launches


def bound_ms(geom, batch: int, cycles: int, passes) -> tuple[float, str]:
    """Least time for one launch: the larger of the bytes it must move
    over the memory rate and its scalar operations over the scalar rate.
    Operations count what this run's data needed: the arbitration passes
    are the kernel's own count."""
    lp1, p = geom.route.shape
    np1, fc = geom.cand.shape
    fi = geom.intab.shape[1]
    stream = batch * cycles * p * 3            # inj bool + dst int16
    tables = (lp1 * p * 2 + lp1 * (5 * 4 + 1) + p * 4 + np1 * fc * 4
              + lp1 * fi * 4)
    outputs = batch * (lp1 * 4 + 8 * 4 + 24 * 4 + 4)
    nbytes = stream + tables + outputs
    # Per cycle and row: route and score (12), dequeue and counts (14),
    # fan-in enqueue and injection (4 per entry + 12).  Per arbitration
    # pass: the channel row-max (4 per candidate + 2), winners, feasibility
    # and the active update (12 per row).
    per_cycle = lp1 * (12 + 14 + 4 * fi + 12)
    per_pass = np1 * (4 * fc + 2) + lp1 * 12
    ops = batch * cycles * per_cycle + int(passes.sum()) * per_pass
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times():
    """Kernel vs twin on the main path's own shapes: the wrapper's output
    held against the plain version on the same streams, then timed."""
    from repro_torch.core import sim
    from repro_torch.kernels import noc_step

    exps, _ = main_path_experiments()
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    err = 0.0
    reps = 5
    for topo, cfgs in main_path_groups(exps):
        c0 = cfgs[0]
        geom = sim.build_geometry(topo, "cuda")
        points = [sim.make_point(c, topo.n_pes) for c in cfgs]
        inj, dst = sim.draw_streams(points, topo.n_pes, c0.cycles, "cuda")
        kw = dict(warmup=c0.warmup, starvation_limit=c0.starvation_limit,
                  arb_iters=sim.ARB_ITERS)
        got = noc_step.run_fused(geom, inj, dst, **kw)       # warm-up
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(reps):
            noc_step.run_fused(geom, inj, dst, **kw)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
        start.record()
        want = noc_step.run_plain(geom, inj, dst, **kw)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        for x, y in zip(got, want):
            assert torch.equal(x, y), topo.name
            err = max(err, float((x.long() - y.long()).abs().max()))
        b_ms, by = bound_ms(geom, len(cfgs), c0.cycles, got[3])
        bound_by.add(by)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += b_ms
        us_cycle_point = ms * 1e3 / c0.cycles / len(cfgs)
        say(4, f"{topo.name}: L+1={geom.route.shape[0]} batch={len(cfgs)} "
               f"cycles={c0.cycles} | kernel {ms:.3f} ms/launch "
               f"({us_cycle_point:.3f} us per cycle per point) | twin on "
               f"the card {plain_ms:.1f} ms | bound {b_ms:.4f} ms ({by}) | "
               f"arbitration passes {got[3].tolist()} | kernel == twin "
               f"[{CARD}]")
    return total, ("bytes" if bound_by == {"bytes"} else "operations"), err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    phase_device()
    err = phase_parity()
    launches = phase_main_path()
    total, bound_by, err_main = phase_times()
    say(4, f"main path: {launches} launches, kernel {total['ms']:.3f} ms "
           f"in all, twin {total['plain_ms']:.1f} ms, bound "
           f"{total['bound_ms']:.4f} ms [{CARD}]; whole run "
           f"{time.perf_counter() - t0:.1f} s")
    record = {"kernels": [{
        "name": "noc_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(err, err_main), "ms": total["ms"],
        "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": bound_by, "library_ms": None}]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
