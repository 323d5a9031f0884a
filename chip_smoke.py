"""Drive the PyTorch/CUDA port of the NoC simulator on one NVIDIA card.

    python3 chip_smoke.py

Runs from a checkout of the repository, needs one CUDA device and nvcc,
and imports nothing of jax or of the JAX reference package.  It builds the
port's CUDA kernel from ``src/repro_torch/kernels/csrc`` and runs seven
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
5. Trace replay at full width: the recipe of ``benchmarks/trace_replay.py``
   (the three mined collective schedules, 64/256/1024 PEs, both families,
   ``src_queue_depth=8``, injection rate 1.0, seed 1) through
   ``Experiment.run_grid`` on the CUDA backend, held field for field to
   ``tests/data/torch_port_trace_fault_reference.json`` and, for
   ``completion_cycles`` and ``delivered``, to the 18 ``trace_replay`` rows
   of ``BENCH_noc.json``; kernel == twin on the card at 64 and 256 PEs; the
   stall-watchdog demo (16 PEs, strict and lenient barriers).
6. Runtime faults: the recipe of ``benchmarks/fault_sweep.py`` at 256 and
   1024 PEs (healthy, 2/4/8 dead links x fault seeds 0/1 unrepaired, the
   repaired twin) through ``run_experiments``, held to the same reference
   file with conservation checked per point; kernel == twin on the card at
   64 PEs, a transient fault with a late onset included.
7. Times of the trace and fault modes, as in phase 4, on every launch of
   phases 5 and 6 that runs them.

Launch counts are zeroed just before each of phases 3, 5 and 6 and read
just after, by mode.  Phases 5 and 6 split their host wall clock into its
stages (topology builds, device geometry, streams and operands, the
kernel, the reachability walk, the rest).  The line before the last is the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(ROOT, "tests", "data", "torch_port_reference.json")
TRACE_FAULT_REFERENCE = os.path.join(
    ROOT, "tests", "data", "torch_port_trace_fault_reference.json")
BENCH = os.path.join(ROOT, "BENCH_noc.json")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/noc_step.cu"
REPLACES = {
    "noc_step": "src/repro/kernels/noc_step.py:371",
    "noc_step[trace]":
        "src/repro/kernels/noc_step.py:137-148,294-304,329-365,538-552",
    "noc_step[faults]": "src/repro/kernels/noc_step.py:232-241,506-525",
}

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
    """Largest absolute difference over two results' numeric fields,
    per-phase completion cycles included."""
    fa, fb = fields(a), fields(b)
    err = max(abs(fa[k] - fb[k]) for k in fa
              if isinstance(fa[k], (int, float)))
    if len(fa["phase_done"]) != len(fb["phase_done"]):
        return float("inf")
    return max([err] + [abs(x - y) for x, y in zip(fa["phase_done"],
                                                   fb["phase_done"])])


def as_reference(r) -> dict:
    """A SimResult's fields as the reference JSON records them."""
    d = fields(r)
    d["phase_done"] = list(d["phase_done"])
    return d


@contextlib.contextmanager
def host_clock(targets):
    """Host seconds spent inside each of ``targets`` ((owner, attribute)
    pairs) while the block runs: each is wrapped for the block's length,
    and the device is synchronized before a call's clock stops, so a call
    that launches device work is charged for it."""
    spent, saved = {}, []
    for owner, name in targets:
        fn = getattr(owner, name)
        spent[name] = 0.0

        def wrapped(*a, _fn=fn, _name=name, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[_name] += time.perf_counter() - t
        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)
    try:
        yield spent
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def host_split(wall: float, spent: dict) -> str:
    parts = [f"{k} {v:.3f} s" for k, v in spent.items()]
    return (f"{wall:.3f} s host wall clock = " + ", ".join(parts)
            + f", rest {wall - sum(spent.values()):.3f} s")


def clocked_targets():
    """The host-side stages of a run that ``host_clock`` times apart:
    topology builds, device geometry, random streams and operands, the
    kernel (run_fused, synchronized) and the reachability walk."""
    from repro_torch.core import sim
    from repro_torch.core.spec import TopologySpec
    from repro_torch.kernels import noc_step
    return ((TopologySpec, "build"), (sim, "build_geometry"),
            (sim, "batch_operands"), (noc_step, "run_fused"),
            (sim, "_fault_reachability"))


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
    launches = noc_step.mode_launches[noc_step.STATISTICAL]
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


def bound_ms(geom, batch: int, cycles: int, passes, n_phases: int = 0,
             n_faults: int = 0, moved: int = 0) -> tuple[float, str]:
    """Least time for one launch: the larger of the bytes it must move
    over the memory rate and its scalar operations over the scalar rate.
    Operations count what this run's data needed: the arbitration passes
    are the kernel's own count, and the fault checks on moved flits use
    the run's own count of moves."""
    lp1, p = geom.route.shape
    np1, fc = geom.cand.shape
    fi = geom.intab.shape[1]
    stream = batch * cycles * p * 3            # inj bool + dst int16
    tables = (lp1 * p * 2 + lp1 * (5 * 4 + 1) + p * 4 + np1 * fc * 4
              + lp1 * fi * 4)
    outputs = batch * (lp1 * 4 + 8 * 4 + 24 * 4 + 4)
    # Trace replay: the phase tables (dst and flits [n_phases, P], totals
    # [n_phases]) in, the completion cycles [n_phases] out.  Faults: the
    # [cycles, F] float32 draws and the [F] entries in.
    trace_bytes = batch * n_phases * (2 * p * 4 + 4 + 4)
    fault_bytes = batch * (cycles * n_faults * 4 + n_faults * 12)
    nbytes = stream + tables + outputs + trace_bytes + fault_bytes
    # Per cycle and row: route and score (12), dequeue and counts (14),
    # fan-in enqueue and injection (4 per entry + 12).  Per arbitration
    # pass: the channel row-max (4 per candidate + 2), winners, feasibility
    # and the active update (12 per row).  Trace: the phase gate and the
    # sent count per PE (4) and the barrier update (10) per cycle.
    # Faults: the active flag of each entry (3) per cycle, and a compare
    # with every entry (2) per moved flit.
    per_cycle = lp1 * (12 + 14 + 4 * fi + 12)
    if n_phases:
        per_cycle += 4 * p + 10
    per_cycle += 3 * n_faults
    per_pass = np1 * (4 * fc + 2) + lp1 * 12
    ops = (batch * cycles * per_cycle + int(passes.sum()) * per_pass
           + 2 * n_faults * moved)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_launch(phase: int, topo, cfgs, reps: int) -> dict:
    """One launch of the path on ``topo``: the wrapper's output held
    against the plain version on the same inputs, then both timed with
    CUDA events (the kernel after a warm-up, over ``reps`` launches)."""
    from repro_torch.core import sim
    from repro_torch.kernels import noc_step

    c0 = cfgs[0]
    geom = sim.build_geometry(topo, "cuda")
    points = [sim.make_point(c, topo.n_pes, topo) for c in cfgs]
    inj, dst, trace, faults, fault_u = sim.batch_operands(
        points, topo.n_pes, c0.cycles, "cuda")
    kw = dict(warmup=c0.warmup, starvation_limit=c0.starvation_limit,
              arb_iters=sim.ARB_ITERS, trace=trace, faults=faults,
              fault_u=fault_u, strict_barrier=c0.strict_barrier,
              watchdog=c0.watchdog)
    got = noc_step.run_fused(geom, inj, dst, **kw)        # warm-up
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
    err = 0.0
    for x, y in zip(got, want):
        assert torch.equal(x, y), topo.name
        if x.numel():
            err = max(err, float((x.long() - y.long()).abs().max()))
    n_phases = 0 if trace is None else trace[0].shape[1]
    n_faults = 0 if faults is None else faults[0].shape[1]
    moved = int(got[1][:, noc_step.MOVED].sum())
    b_ms, by = bound_ms(geom, len(cfgs), c0.cycles, got[3], n_phases,
                        n_faults, moved)
    modes = "+".join(noc_step.launch_modes(trace, faults))
    say(phase, f"{topo.name} {modes}: L+1={geom.route.shape[0]} "
               f"batch={len(cfgs)} cycles={c0.cycles} phases={n_phases} "
               f"fault entries={n_faults} | kernel {ms:.3f} ms/launch "
               f"({ms * 1e3 / c0.cycles / len(cfgs):.3f} us per cycle per "
               f"point) | twin on the card {plain_ms:.1f} ms | bound "
               f"{b_ms:.4f} ms ({by}) | arbitration passes "
               f"{got[3].tolist()} | kernel == twin [{CARD}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "by": by,
            "err": err}


def summed(rows: list[dict]) -> dict:
    by = {r["by"] for r in rows}
    return {"ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "err": max(r["err"] for r in rows)}


def path_groups(exps, modes=None):
    """(topology, configs) of each launch ``run_experiments`` makes for
    ``exps`` (one per geometry and batch shape), in order; with ``modes``,
    only the launches that run one of those kernel modes."""
    from repro_torch.core import sweep, traffic
    from repro_torch.kernels import noc_step

    by_spec: dict = {}
    for e in exps:
        by_spec.setdefault(e.topology, []).append(e.sim_config())
    out = []
    for spec, cfgs in by_spec.items():
        topo = spec.build()
        for idxs in sweep._grouped(topo, cfgs).values():
            group = [cfgs[i] for i in idxs]
            c0 = group[0]
            launch = noc_step.launch_modes(
                True if traffic.resolve(c0.pattern).is_trace else None,
                c0.faults or None)
            if modes is None or set(launch) & set(modes):
                out.append((topo, group))
    return out


def phase_times():
    """Kernel vs twin on the main path's own shapes, timed."""
    exps, _ = main_path_experiments()
    rows = [time_launch(4, topo, cfgs, reps=5)
            for topo, cfgs in path_groups(exps)]
    return summed(rows)


# ---------------------------------------------------------------------------
def _spec(family: str, n: int, depth: int):
    from repro_torch.core.spec import TopologySpec
    return TopologySpec(family, n, src_queue_depth=depth)


def trace_grid(ref, sizes, backend: str):
    """The trace_replay recipe: one ``run_grid`` per (size, family), the
    three schedules as its traffic axis.  Returns (tags, reports)."""
    from repro_torch import trace as tr
    from repro_torch.core.experiment import Budget, Experiment

    r = ref["recipes"]["trace_replay"]
    depth = ref["recipes"]["src_queue_depth"]
    tags, reports = [], []
    for n in sizes:
        traces = tr.traces_for_schedules(
            n, pod_size=r["pod_size"], algorithm=r["algorithm"],
            normalize_flits=r["normalize_flits"])
        budget = Budget(cycles=r["cycles"][str(n)], warmup=0,
                        backend=backend)
        for fam in ("ring_mesh", "flat_mesh"):
            exp = Experiment(topology=_spec(fam, n, depth),
                             traffic=next(iter(traces.values())),
                             budget=budget, inj_rate=r["inj_rate"],
                             seed=r["seed"])
            reports += exp.run_grid(traffics=tuple(traces.values()))
            tags += [(fam, n, sched) for sched in traces]
    return tags, reports


def watchdog_demo(ref, backend: str):
    from repro_torch import trace as tr
    from repro_torch.core.experiment import Budget, Experiment
    from repro_torch.faults import FaultSpec

    w = ref["recipes"]["watchdog"]
    trace = tr.from_records(w["n_pes"], w["phases"])
    out = {}
    for mode, strict, wd in (("strict", True, w["watchdog"]),
                             ("lenient", False, 0)):
        out[mode] = Experiment(
            topology=_spec("ring_mesh", w["n_pes"],
                           ref["recipes"]["src_queue_depth"]),
            traffic=trace,
            budget=Budget(cycles=w["cycles"], warmup=0,
                          strict_barrier=strict, watchdog=wd,
                          backend=backend),
            inj_rate=1.0,
            faults=FaultSpec(dead_routers=tuple(w["dead_routers"]))).run()
    return out


def phase_trace(ref) -> tuple[int, float, list]:
    """Trace replay at full width.  Returns (trace-mode launches of the
    path, largest kernel-vs-twin difference, the path's experiments)."""
    from repro_torch.kernels import noc_step

    want = {(p["family"], p["n_pes"], p["schedule"]): p
            for p in ref["trace_replay"]}
    with open(BENCH) as f:
        bench = {(row["topology"], row["n_pes"], row["schedule"]): row
                 for row in json.load(f)["tables"]["trace_replay"]["rows"]}
    sizes = ref["recipes"]["trace_replay"]["sizes"]
    noc_step.reset_launches()
    with host_clock(clocked_targets()) as spent:
        t0 = time.perf_counter()
        tags, reports = trace_grid(ref, sizes, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = noc_step.mode_launches[noc_step.TRACE]
    say(5, f"run_grid over {len(reports)} trace points: launches by mode "
           f"{noc_step.mode_launches}, {host_split(wall, spent)} [{CARD}]")
    assert launches > 0, "the trace path never launched the kernel's mode"
    for tag, rep in zip(tags, reports):
        assert as_reference(rep.sim) == {
            k: v for k, v in want[tag].items()
            if k not in ("family", "schedule")}, tag
        row = bench[tag]
        assert (rep.completion_cycles, rep.sim.delivered) == (
            row["completion_cycles"], row["delivered"]), (tag, row)
        say(5, f"{tag}: {rep.sim.n_phases} phases, completion "
               f"{rep.completion_cycles} cycles, delivered "
               f"{rep.sim.delivered} == reference == BENCH_noc.json")
    say(5, f"all {len(reports)} points equal the reference (jax "
           f"{ref['jax_version']}) field for field, phase_done included, "
           f"and all {len(bench)} BENCH_noc.json trace_replay rows "
           f"reproduce")
    err = 0.0
    small = [n for n in sizes if n <= 256]
    kernel = [(t, r) for t, r in zip(tags, reports) if t[1] in small]
    _, twin = trace_grid(ref, small, "torch")
    for (tag, a), b in zip(kernel, twin):
        assert fields(a.sim) == fields(b.sim), tag
        err = max(err, result_err(a.sim, b.sim))
    say(5, f"kernel == twin on the card over the {len(twin)} points at "
           f"{small} PEs")
    demo = watchdog_demo(ref, "cuda")
    demo_twin = watchdog_demo(ref, "torch")
    for p in ref["watchdog"]:
        got = demo[p["mode"]].sim
        assert as_reference(got) == {k: v for k, v in p.items()
                                     if k != "mode"}, p["mode"]
        assert fields(got) == fields(demo_twin[p["mode"]].sim)
        err = max(err, result_err(got, demo_twin[p["mode"]].sim))
    strict, lenient = demo["strict"].sim, demo["lenient"].sim
    assert (list(strict.phase_done), strict.stall_unretired,
            strict.stalled_phase, strict.stall_cycle) == ([5, -76], 4, 1, 74)
    assert list(lenient.phase_done) == [5, 10] and lenient.dropped == 4
    say(5, f"watchdog demo: strict phase_done {list(strict.phase_done)}, "
           f"phase {strict.stalled_phase} stalled at cycle "
           f"{strict.stall_cycle} with {strict.stall_unretired} unretired "
           f"credits; lenient {list(lenient.phase_done)} with "
           f"{lenient.dropped} drops; kernel == twin == reference")
    return launches, err, [r.experiment for r in reports]


def fault_grid(ref, sizes, backend: str):
    """The fault_tolerance recipe as Experiments: (tags, experiments)."""
    from repro_torch.core.experiment import Budget, Experiment
    from repro_torch.faults import sample_faults, suggest_repair_morph

    r = ref["recipes"]["fault_tolerance"]
    depth = ref["recipes"]["src_queue_depth"]
    tags, exps = [], []
    for n in sizes:
        budget = Budget(cycles=r["cycles"][str(n)], warmup=0,
                        backend=backend)
        inj = r["inj_rate"][str(n)]
        for fam in ("ring_mesh", "flat_mesh"):
            spec = _spec(fam, n, depth)
            topo = spec.build()
            scen = {(c, s): sample_faults(topo, n_dead_links=c, seed=s)
                    for c in r["counts"] for s in r["seeds"]}
            exps.append(Experiment(topology=spec, budget=budget,
                                   inj_rate=inj, seed=r["seed"]))
            tags.append((fam, n, "healthy", 0, 0, None))
            for (c, s), f in scen.items():
                exps.append(Experiment(topology=spec, budget=budget,
                                       inj_rate=inj, seed=r["seed"],
                                       faults=f))
                tags.append((fam, n, "faulted", c, s, f))
            rc, rs = r["repair_count"], r["seeds"][0]
            exps.append(Experiment(
                topology=suggest_repair_morph(spec, scen[(rc, rs)]),
                budget=budget, inj_rate=inj, seed=r["seed"]))
            tags.append((fam, n, "repaired", rc, rs, scen[(rc, rs)]))
    return tags, exps


def phase_faults(ref) -> tuple[int, float, list]:
    """Runtime faults at 256 and 1024 PEs.  Returns (fault-mode launches
    of the path, largest kernel-vs-twin difference, the experiments)."""
    from repro_torch.core import sim
    from repro_torch.core.experiment import run_experiments
    from repro_torch.faults import FaultSpec, LinkFault, sample_faults
    from repro_torch.kernels import noc_step

    want = {(p["family"], p["n_pes"], p["mode"], p["n_dead_links"],
             p["fault_seed"]): p for p in ref["fault_tolerance"]}
    skip = ("family", "mode", "n_dead_links", "fault_seed", "faults")

    def check(tags, reports):
        for (fam, n, mode, c, s, f), rep in zip(tags, reports):
            p = want[(fam, n, mode, c, s)]
            assert (f.to_dict() if f else None) == p["faults"], (fam, n, c)
            r = rep.sim
            assert as_reference(r) == {k: v for k, v in p.items()
                                       if k not in skip}, (fam, n, mode, c)
            assert r.offered == r.delivered + r.dropped + r.in_flight, (
                fam, n, mode, c, s)

    tags, exps = fault_grid(ref, (256, 1024), "cuda")
    noc_step.reset_launches()
    with host_clock(clocked_targets()) as spent:
        t0 = time.perf_counter()
        reports = run_experiments(exps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = noc_step.mode_launches[noc_step.FAULTS]
    say(6, f"run_experiments over {len(exps)} points: launches by mode "
           f"{noc_step.mode_launches}, {host_split(wall, spent)} [{CARD}]")
    assert launches > 0, "the fault path never launched the kernel's mode"
    check(tags, reports)
    for tag, rep in zip(tags, reports):
        if tag[2] != "faulted" or tag[3] == 8:
            say(6, f"{tag[:5]}: reachability {rep.reachability:.4f}, "
                   f"delivered fraction {rep.delivered_fraction:.4f}, "
                   f"dropped {rep.sim.dropped}")
    say(6, f"all {len(reports)} points equal the reference (jax "
           f"{ref['jax_version']}) field for field; offered == delivered "
           f"+ dropped + in_flight at every point")

    err = 0.0
    tags64, k64 = fault_grid(ref, (64,), "cuda")
    _, t64 = fault_grid(ref, (64,), "torch")
    kr, tr_ = run_experiments(k64), run_experiments(t64)
    check(tags64, kr)
    for tag, a, b in zip(tags64, kr, tr_):
        assert fields(a.sim) == fields(b.sim), tag
        err = max(err, result_err(a.sim, b.sim))
    spec = _spec("ring_mesh", 64, ref["recipes"]["src_queue_depth"])
    topo = spec.build()
    chans = sample_faults(topo, n_dead_links=3, seed=9).dead_links
    late = FaultSpec(dead_links=chans[:1], transient=(
        LinkFault(link=chans[1], drop_p=0.5, onset=250),
        LinkFault(link=chans[2], drop_p=1.0, onset=400)))
    kw = dict(cycles=800, warmup=0, inj_rate=0.3, seed=4, faults=late)
    a = sim.simulate(topo, sim.SimConfig(backend="cuda", **kw))
    b = sim.simulate(topo, sim.SimConfig(backend="torch", device="cuda",
                                         **kw))
    assert fields(a) == fields(b) and a.lost == 0
    assert a.offered == a.delivered + a.dropped + a.in_flight
    err = max(err, result_err(a, b))
    say(6, f"kernel == twin on the card over the {len(k64)} points of the "
           f"64-PE recipe (which equal the reference too) and a transient "
           f"fault with onsets 250/400 (dropped {a.dropped})")
    return launches, err, exps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import noc_step

    t0 = time.perf_counter()
    phase_device()
    err = phase_parity()
    launches = {noc_step.STATISTICAL: phase_main_path()}
    stat = phase_times()
    say(4, f"main path: {launches[noc_step.STATISTICAL]} launches, kernel "
           f"{stat['ms']:.3f} ms in all, twin {stat['plain_ms']:.1f} ms, "
           f"bound {stat['bound_ms']:.4f} ms [{CARD}]")
    stat["err"] = max(stat["err"], err)
    with open(TRACE_FAULT_REFERENCE) as f:
        ref = json.load(f)
    launches[noc_step.TRACE], trace_err, trace_exps = phase_trace(ref)
    launches[noc_step.FAULTS], fault_err, fault_exps = phase_faults(ref)
    timed = {}
    for mode, exps, e in ((noc_step.TRACE, trace_exps, trace_err),
                          (noc_step.FAULTS, fault_exps, fault_err)):
        rows = [time_launch(7, topo, cfgs, reps=3)
                for topo, cfgs in path_groups(exps, (mode,))]
        assert len(rows) == launches[mode], (mode, len(rows))
        timed[mode] = summed(rows)
        timed[mode]["err"] = max(timed[mode]["err"], e)
        say(7, f"{mode} path: {launches[mode]} launches, kernel "
               f"{timed[mode]['ms']:.3f} ms in all, twin "
               f"{timed[mode]['plain_ms']:.1f} ms, bound "
               f"{timed[mode]['bound_ms']:.4f} ms [{CARD}]")
    timed[noc_step.STATISTICAL] = stat
    say(7, f"whole run {time.perf_counter() - t0:.1f} s")
    record = {"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": timed[name]["err"], "ms": timed[name]["ms"],
        "plain_ms": timed[name]["plain_ms"],
        "bound_ms": timed[name]["bound_ms"],
        "bound_by": timed[name]["bound_by"], "library_ms": None}
        for name in (noc_step.STATISTICAL, noc_step.TRACE, noc_step.FAULTS)]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
