"""The port's trace replay vs the reference's, on the CPU.

``repro_torch.trace`` (spec, extractors, the HLO census) must build the
same ``TraceSpec``s as ``repro.trace``, and the port's simulator (the plain
twin, ``backend="torch"`` on the CPU) must replay them exactly as
``repro.core.sim.simulate(..., backend="xla")`` does: every ``SimResult``
field, the per-phase completion cycles ``phase_done`` included, over both
families — phase gating, throttled injection, budget exhaustion and a grid
that batches trace points beside statistical ones (the matrix of
tests/test_trace.py).  Reports load in each package from the other's JSON.
The 64-PE ring-mesh points of ``tests/data/torch_port_trace_fault_reference
.json`` (the trace_replay recipe) reproduce.  Tolerance: exact.

The CUDA kernel's trace mode runs only on the card:
``test_cuda_trace_mode_matches_twin`` is marked ``cuda`` and skips here.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import trace as r_tr
from repro.core import experiment as r_exp
from repro.core import sim as r_sim
from repro.core import spec as r_spec
from repro.core import sweep as r_sweep
from repro_torch import trace as t_tr
from repro_torch.core import experiment as t_exp
from repro_torch.core import sim as t_sim
from repro_torch.core import spec as t_spec
from repro_torch.core import sweep as t_sweep
from repro_torch.core import traffic as t_traffic
from repro_torch.launch import hlo as t_hlo
from test_launch import SAMPLE_TRACE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "tests", "data",
                         "torch_port_trace_fault_reference.json")
P16 = 16
TWO_PHASE = [[(0, 8, 3), (1, 9, 3)], [(8, 0, 2), (9, 1, 2)]]


def _fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name != "cfg"}


def _both(family, records, n=P16, **cfg_kw):
    """The same trace through each package's simulate; returns the port's
    result after holding it to the reference's."""
    rx = r_sim.simulate(r_spec.TopologySpec(family, n).build(),
                        r_sim.SimConfig(pattern=r_tr.from_records(
                            n, records), backend="xla", **cfg_kw))
    rt = t_sim.simulate(t_spec.TopologySpec(family, n).build(),
                        t_sim.SimConfig(pattern=t_tr.from_records(
                            n, records), backend="torch", device="cpu",
                            **cfg_kw))
    assert _fields(rt) == _fields(rx), (cfg_kw, rx.row(), rt.row())
    assert rt.row() == rx.row()
    return rt


def _spec_dict(spec):
    return json.loads(spec.to_json())


# ---------------------------------------------------------------------------
# Specs and extractors
# ---------------------------------------------------------------------------
def test_trace_specs_and_arrays_equal_reference():
    """Every front end builds the same TraceSpec in both packages: JSON,
    phase-table arrays and the flit arithmetic."""
    for b in (0, 1, 32, 33, 1000):
        for kw in ({}, {"flit_bytes": 8}, {"scale": 3.5}):
            assert (t_tr.flits_for_bytes(b, **kw)
                    == r_tr.flits_for_bytes(b, **kw))
    pairs = [
        (r_tr.dist_to_trace(s, 64, 1 << 20, pod_size=16, normalize_flits=4),
         t_tr.dist_to_trace(s, 64, 1 << 20, pod_size=16, normalize_flits=4))
        for s in r_tr.DIST_SCHEDULES]
    census = {"bytes_by_kind": {"reduce-scatter": 4096, "all-reduce": 512,
                                "all-to-all": 1024},
              "count_by_kind": {"reduce-scatter": 2, "all-reduce": 1}}
    for algo in r_tr.ALGORITHMS:
        pairs.append((r_tr.schedule_to_trace(census, 32, pod_size=8,
                                             algorithm=algo, per_op=True),
                      t_tr.schedule_to_trace(census, 32, pod_size=8,
                                             algorithm=algo, per_op=True)))
    for rs, ts in pairs:
        assert _spec_dict(ts) == _spec_dict(rs)
        for ra, ta in zip(rs.arrays(), ts.arrays()):
            assert np.array_equal(ra, ta) and ta.dtype == np.int32
        assert t_tr.completion_budget(ts) == r_tr.completion_budget(rs)
        assert t_tr.TraceSpec.from_json(rs.to_json()) == ts
    assert (t_tr.permute_phase([(0, 1), (0, 2), (1, 3)], 4, 64)
            == r_tr.permute_phase([(0, 1), (0, 2), (1, 3)], 4, 64))


def test_schedules_and_hlo_fixture_equal_reference():
    """``load_schedules`` on the mined schedules, ``traces_for_schedules``
    at every trace_replay size, and ``hlo_to_trace`` on the JAX tests' HLO
    fixture (all-to-all, async all-gather, collective-permutes)."""
    path = os.path.join(ROOT, t_tr.SCHEDULES_JSON)
    assert t_tr.load_schedules(path) == r_tr.load_schedules(path)
    for n in (16, 64, 256, 1024):
        rt = r_tr.traces_for_schedules(n, path, pod_size=16)
        tt = t_tr.traces_for_schedules(n, path, pod_size=16)
        assert list(tt) == list(rt) == ["flat", "hier", "hier_int8"]
        for k in rt:
            assert tt[k].to_dict() == rt[k].to_dict()
            assert tt[k].n_trace_phases == rt[k].n_trace_phases
    from repro.launch import hlo as r_hlo
    assert t_hlo.collective_ops(SAMPLE_TRACE) == r_hlo.collective_ops(
        SAMPLE_TRACE)
    for algo in r_tr.ALGORITHMS:
        rs = r_tr.hlo_to_trace(SAMPLE_TRACE, 8, algorithm=algo)
        ts = t_tr.hlo_to_trace(SAMPLE_TRACE, 8, algorithm=algo)
        assert _spec_dict(ts) == _spec_dict(rs)
    with pytest.raises(ValueError, match="no collective ops"):
        t_tr.hlo_to_trace("%f = f32[4]{0} fusion(%a)", 4)
    with pytest.raises(ValueError, match="unknown collective kind"):
        t_tr.schedule_to_trace({"bytes_by_kind": {"broadcast": 8}}, 16)


def test_trace_kind_resolves_lazily_in_a_fresh_interpreter():
    """A trace ``Report``'s JSON loads in a fresh interpreter without
    ``repro_torch.trace`` imported first: the registry imports it on first
    sight of the kind."""
    exp = t_exp.Experiment(
        topology=t_spec.TopologySpec("ring_mesh", P16),
        traffic=t_tr.from_records(P16, TWO_PHASE), inj_rate=1.0,
        budget=t_exp.Budget(cycles=120, warmup=0, backend="torch",
                            device="cpu"))
    rep = exp.run()
    text = rep.to_json()
    code = ("import sys\n"
            "from repro_torch.core.experiment import Report\n"
            "assert 'repro_torch.trace' not in sys.modules\n"
            "rep = Report.from_json(sys.stdin.read())\n"
            "print(rep.sim.phase_done, rep.experiment.traffic.kind)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], input=text,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"{rep.sim.phase_done} trace"
    with pytest.raises(TypeError, match="TraceSpec"):
        t_traffic.resolve("trace")


# ---------------------------------------------------------------------------
# Replay semantics, held to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_phase_gating_matches_reference(family):
    r = _both(family, TWO_PHASE, cycles=200, warmup=0, inj_rate=1.0)
    assert r.trace_completed
    d0, d1 = r.phase_done
    assert 0 < d0 < d1
    l0, l1 = r.phase_latencies()
    assert l0 == d0 + 1 and l1 == d1 - d0 and l1 >= 2
    assert r.completion_cycles == d1 + 1
    assert r.delivered == 10 and r.dropped == 0 and r.in_flight == 0
    assert r.offered == r.delivered  # trace-mode conservation


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_throttled_injection_matches_reference(family):
    full = _both(family, TWO_PHASE, cycles=200, warmup=0, inj_rate=1.0)
    slow = _both(family, TWO_PHASE, cycles=200, warmup=0, inj_rate=0.3,
                 seed=3)
    assert slow.trace_completed
    assert slow.completion_cycles >= full.completion_cycles
    assert slow.delivered == full.delivered == 10


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_budget_exhaustion_matches_reference(family):
    r = _both(family, TWO_PHASE, cycles=6, warmup=0, inj_rate=1.0)
    assert not r.trace_completed
    assert r.completion_cycles == -1
    assert -1 in r.phase_done and -1 in r.phase_latencies()


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_extracted_schedule_matches_reference(family):
    """A real extracted schedule (the flat DP all-reduce) replays
    identically."""
    spec = r_tr.dist_to_trace("flat", P16, 1 << 16, normalize_flits=4)
    r = _both(family, [list(ph) for ph in spec.phases], cycles=400,
              warmup=0, inj_rate=1.0)
    assert r.trace_completed and r.n_phases == spec.n_phases


def test_grid_batches_trace_with_statistical_points():
    """Mixed trace + statistical configs on one topology sweep in one call
    (two batches: the phase count is a batch shape), equal to per-point
    runs and to the reference's sweep."""
    kw = [dict(cycles=200, warmup=0, inj_rate=1.0, seed=0, trace=True),
          dict(cycles=200, warmup=0, inj_rate=0.25, seed=0),
          dict(cycles=200, warmup=0, inj_rate=0.6, seed=2, trace=True)]

    def cfgs(mod, pkg_tr, **extra):
        return [mod.SimConfig(
            **{k: v for k, v in c.items() if k != "trace"},
            pattern=(pkg_tr.from_records(P16, TWO_PHASE) if c.get("trace")
                     else "uniform"), **extra) for c in kw]

    rc = cfgs(r_sim, r_tr)
    tc = cfgs(t_sim, t_tr, backend="torch", device="cpu")
    rr = r_sweep.sweep(r_spec.TopologySpec("ring_mesh", P16).build(), rc)
    topo = t_spec.TopologySpec("ring_mesh", P16).build()
    tt = t_sweep.sweep(topo, tc)
    assert [_fields(a) for a in tt] == [_fields(b) for b in rr]
    assert tt[0].trace_completed and tt[1].phase_done == ()
    assert tt[2] == t_sim.simulate(topo, tc[2])


def test_experiment_grid_and_report_json_both_ways():
    """``run_grid`` over the three mined schedules at 16 PEs: the port's
    Report JSON equals the reference's once the backend's name is
    normalized, and each package loads the other's."""
    rtr = r_tr.traces_for_schedules(P16, pod_size=4)
    ttr = t_tr.traces_for_schedules(P16, pod_size=4)
    rr = r_exp.Experiment(
        topology=r_spec.TopologySpec("ring_mesh", P16),
        traffic=rtr["flat"], inj_rate=1.0,
        budget=r_exp.Budget(cycles=400, warmup=0)).run_grid(
            traffics=tuple(rtr.values()))
    tt = t_exp.Experiment(
        topology=t_spec.TopologySpec("ring_mesh", P16),
        traffic=ttr["flat"], inj_rate=1.0,
        budget=t_exp.Budget(cycles=400, warmup=0, backend="torch",
                            device="cpu")).run_grid(
            traffics=tuple(ttr.values()))
    for rrep, trep in zip(rr, tt):
        assert trep.sim.trace_completed and trep.completion_cycles > 0
        assert trep.phase_latencies == rrep.phase_latencies
        assert trep.completion_cycles == rrep.completion_cycles
        assert trep.row() == rrep.row()
        rd, td = json.loads(rrep.to_json()), json.loads(trep.to_json())
        for d in (rd, td):
            d["experiment"]["budget"]["backend"] = "x"
            d["sim"]["cfg"]["backend"] = "x"
        assert td == rd
        assert t_exp.Report.from_json(trep.to_json()) == trep
        back = r_exp.Report.from_json(trep.to_json().replace(
            '"backend": "torch"', '"backend": "xla"'))
        assert back == rrep
        again = t_exp.Report.from_json(rrep.to_json().replace(
            '"backend": "xla"', '"backend": "torch"'))
        assert again.sim == dataclasses.replace(trep.sim, cfg=again.sim.cfg)
        assert again.sim.phase_done == rrep.sim.phase_done


def test_reference_json_64_pe_trace_points_reproduce():
    """The trace_replay recipe's 64-PE ring-mesh points (all three
    schedules in one batch) equal the reference JSON field for field."""
    with open(REFERENCE) as f:
        ref = json.load(f)
    r = ref["recipes"]["trace_replay"]
    traces = t_tr.traces_for_schedules(
        64, os.path.join(ROOT, t_tr.SCHEDULES_JSON), pod_size=r["pod_size"],
        algorithm=r["algorithm"], normalize_flits=r["normalize_flits"])
    exp = t_exp.Experiment(
        topology=t_spec.TopologySpec(
            "ring_mesh", 64,
            src_queue_depth=ref["recipes"]["src_queue_depth"]),
        traffic=traces["flat"], inj_rate=r["inj_rate"], seed=r["seed"],
        budget=t_exp.Budget(cycles=r["cycles"]["64"], warmup=0,
                            backend="torch", device="cpu"))
    reports = exp.run_grid(traffics=tuple(traces.values()))
    want = {p["schedule"]: p for p in ref["trace_replay"]
            if p["family"] == "ring_mesh" and p["n_pes"] == 64}
    for sched, rep in zip(traces, reports):
        got = _fields(rep.sim)
        got["phase_done"] = list(got["phase_done"])
        assert got == {k: v for k, v in want[sched].items()
                       if k not in ("family", "schedule")}, sched
    assert [rep.completion_cycles for rep in reports] == [458, 176, 436]


@pytest.mark.cuda
def test_cuda_trace_mode_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    topo = t_spec.TopologySpec("flat_mesh", 64).build()
    traces = t_tr.traces_for_schedules(
        64, os.path.join(ROOT, t_tr.SCHEDULES_JSON), pod_size=16)
    for backend in ("cuda", "torch"):
        cfgs = [t_sim.SimConfig(cycles=600, warmup=0, inj_rate=1.0,
                                pattern=t, seed=1, backend=backend,
                                device="cuda") for t in traces.values()]
        if backend == "cuda":
            got = t_sweep.sweep(topo, cfgs)
        else:
            want = t_sweep.sweep(topo, cfgs)
    assert [_fields(a) for a in got] == [_fields(b) for b in want]
