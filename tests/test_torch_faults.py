"""The port's runtime fault injection vs the reference's, on the CPU.

``FaultSpec.lower``/``n_lowered`` and the repair helpers must give the
reference's arrays and specs, and the port's simulator (the plain twin,
``backend="torch"`` on the CPU) must run faulted points exactly as
``repro.core.sim.simulate(..., backend="xla")`` does — every
``SimResult`` field, ``reachability`` and ``stall_unretired`` included —
over the matrix of tests/test_faults.py: conservation under dead links,
dead routers and transient faults on both families, onset gating, the
6-way random stream of faulted points, repaired vs unrepaired fabrics, the
stall watchdog's diagnostic (phase 1, cycle 74, 4 credits) and the lenient
barrier's completion, and a fault grid batched against per-point runs.
Reports load in each package from the other's JSON.  Tolerance: exact.

The CUDA kernel's fault mode runs only on the card:
``test_cuda_fault_mode_matches_twin`` is marked ``cuda`` and skips here.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

# Both packages' ``core`` first: importing ``faults`` before it closes
# the faults.spec -> core -> sim -> faults.spec cycle, in the reference
# and in the port alike.
from repro.core import experiment as r_exp
from repro.core import sim as r_sim
from repro.core import spec as r_spec
from repro.core import sweep as r_sweep
from repro import faults as r_faults
from repro import trace as r_tr
from repro_torch.core import experiment as t_exp
from repro_torch.core import prng
from repro_torch.core import sim as t_sim
from repro_torch.core import spec as t_spec
from repro_torch.core import sweep as t_sweep
from repro_torch import faults as t_faults
from repro_torch import trace as t_tr
from repro_torch.faults import spec as t_fspec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "tests", "data",
                         "torch_port_trace_fault_reference.json")
CPU = dict(backend="torch", device="cpu")


def _fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name != "cfg"}


def _specs(family="ring_mesh", n=16, faults=None):
    """The same topology spec in both packages (``faults`` a pair)."""
    rs, ts = r_spec.TopologySpec(family, n), t_spec.TopologySpec(family, n)
    if faults is not None:
        rs = dataclasses.replace(rs, faults=faults[0])
        ts = dataclasses.replace(ts, faults=faults[1])
    return rs, ts


def _pair(spec_fn, family="ring_mesh", n=16):
    """``spec_fn(faults_module, topology)`` in both packages."""
    rs, ts = _specs(family, n)
    return spec_fn(r_faults, rs.build()), spec_fn(t_faults, ts.build())


def _both(family, flt, n=16, topo_faults=None, **cfg_kw):
    rs, ts = _specs(family, n, topo_faults)
    rx = r_sim.simulate(rs.build(), r_sim.SimConfig(
        backend="xla", faults=flt and flt[0], **cfg_kw))
    rt = t_sim.simulate(ts.build(), t_sim.SimConfig(
        faults=flt and flt[1], **CPU, **cfg_kw))
    assert _fields(rt) == _fields(rx), (cfg_kw, rx.row(), rt.row())
    assert rt.row() == rx.row()
    return rt


_STYLES = {
    "dead_links": lambda m, t: m.sample_faults(t, n_dead_links=3, seed=1),
    "dead_router": lambda m, t: m.sample_faults(t, n_dead_routers=1,
                                                seed=1),
    "transient": lambda m, t: m.sample_faults(t, n_transient=3, drop_p=0.3,
                                              seed=1),
    "onset_mix": lambda m, t: m.sample_faults(t, n_dead_links=1,
                                              n_transient=2, drop_p=0.2,
                                              onset=150, seed=1),
}


# ---------------------------------------------------------------------------
# Lowering and the repair helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_lowered_arrays_equal_reference(family):
    """``lower`` gives the reference's (links, drop_p, onset) arrays, with
    their dtypes and padding, and ``n_lowered`` its bucket, for every
    fault style and for sets large enough to leave the 16-entry floor."""
    for n in (16, 64):
        rt = r_spec.TopologySpec(family, n).build()
        tt = t_spec.TopologySpec(family, n).build()
        styles = dict(_STYLES, many=lambda m, t: m.sample_faults(
            t, n_dead_links=12, n_dead_routers=1, n_transient=2, seed=3))
        for name, fn in styles.items():
            fr, ft = fn(r_faults, rt), fn(t_faults, tt)
            assert ft.to_dict() == fr.to_dict(), name
            for a, b in zip(fr.lower(rt), ft.lower(tt)):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
            assert ft.n_lowered(tt) == fr.n_lowered(rt) == len(
                ft.lower(tt)[0])
            assert np.array_equal(ft.dead_queue_mask(tt),
                                  fr.dead_queue_mask(rt))
    assert t_fspec._pad_bucket(0) == 0 and t_fspec._PAD_FLOOR == 16
    assert [t_fspec._pad_bucket(k) for k in (1, 16, 17, 33, 64)] == [
        16, 16, 32, 64, 64]


def test_repair_helpers_equal_reference():
    fr, ft = _pair(lambda m, t: m.sample_faults(t, n_dead_links=2,
                                                n_transient=1, seed=4))
    gr, gt = _pair(lambda m, t: m.sample_faults(t, n_dead_links=3,
                                                seed=5))
    for a, b in ((r_faults.merge_faults(fr, gr),
                  t_faults.merge_faults(ft, gt)),
                 (r_faults.merge_faults(None, gr),
                  t_faults.merge_faults(None, gt))):
        assert b.to_dict() == a.to_dict()
    for a, b in zip(r_faults.split_faults(fr), t_faults.split_faults(ft)):
        assert b.to_dict() == a.to_dict()
    rs, ts = _specs("flat_mesh", 16)
    rep_r = r_faults.suggest_repair_morph(rs, fr)
    rep_t = t_faults.suggest_repair_morph(ts, ft)
    assert rep_t.to_dict() == rep_r.to_dict()
    assert rep_t.build().reachable_frac == rep_r.build().reachable_frac
    assert t_faults.healthy_twin(rep_t) == ts
    # measure_repair, once refused for want of the fabric analysis: its
    # three legs (a transient fault stays runtime-injected on the repaired
    # one) and the repaired fabric's certificate equal the reference's.
    got = t_faults.measure_repair(ts, ft, inj_rate=0.3, seed=1,
                                  budget=t_exp.Budget(cycles=300, warmup=0,
                                                      **CPU))
    want = r_faults.measure_repair(rs, fr, inj_rate=0.3, seed=1,
                                   budget=r_exp.Budget(cycles=300,
                                                       warmup=0))
    assert got == want and got["certified"]["ok"]


# ---------------------------------------------------------------------------
# The simulator under faults, held to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
@pytest.mark.parametrize("style", sorted(_STYLES))
def test_conservation_under_faults_matches_reference(family, style):
    """Every offered flit is delivered, dropped or still queued — faults
    destroy flits only through ``dropped`` — and the port equals the
    reference field for field."""
    flt = _pair(_STYLES[style], family)
    r = _both(family, flt, cycles=200, warmup=0, inj_rate=0.3, seed=2)
    assert r.lost == 0
    assert r.offered == r.delivered + r.dropped + r.in_flight
    assert r.delivered > 0 and r.reachability <= 1.0
    assert "reachability" in r.row()


def test_onset_gates_fault_activation():
    """Transient faults with an onset past the horizon never fire: the run
    equals the same fault shape with another drop probability (same
    stream), and is better than onset 0 — in both packages alike."""
    topo = t_spec.TopologySpec("ring_mesh", 16).build()
    chans = t_faults.fabric_channels(topo)[:3]

    def mk(mod, p, onset):
        return mod.FaultSpec(transient=tuple(
            mod.LinkFault(link=int(c), drop_p=p, onset=onset)
            for c in chans))

    def run(p, onset):
        return _both("ring_mesh", (mk(r_faults, p, onset),
                                   mk(t_faults, p, onset)),
                     cycles=200, warmup=0, inj_rate=0.3, seed=1)

    late_a, late_b = run(0.5, 10 ** 6), run(0.9, 10 ** 6)
    assert late_a.row() == late_b.row()
    mid = run(0.5, 120)
    assert run(0.5, 0).dropped > mid.dropped > late_a.dropped


def test_faulted_points_draw_the_six_way_stream():
    """A faulted point splits its key six ways and draws a [cycles, F]
    float32 uniform stream from the sixth key; a healthy point keeps the
    five-way split, so its injections are the reference's healthy ones."""
    topo = t_spec.TopologySpec("ring_mesh", 16).build()
    flt = t_faults.sample_faults(topo, n_dead_links=2, seed=0)
    cycles, seed = 50, 11
    cfg = t_sim.SimConfig(cycles=cycles, warmup=0, inj_rate=0.4, seed=seed,
                          **CPU)
    healthy = t_sim.make_point(cfg, 16, topo)
    faulted = t_sim.make_point(dataclasses.replace(cfg, faults=flt), 16,
                               topo)
    inj_h, _, fu_h = t_sim.draw_streams([healthy], 16, cycles, "cpu")
    inj_f, _, fu_f = t_sim.draw_streams([faulted], 16, cycles, "cpu")
    n_f = faulted.fault_links.shape[0]
    assert fu_h is None and fu_f.shape == (1, cycles, n_f)
    keys6 = jax.random.split(jax.random.PRNGKey(seed), 6)
    keys5 = jax.random.split(jax.random.PRNGKey(seed), 5)
    assert np.array_equal(
        fu_f[0].numpy(), np.asarray(jax.random.uniform(keys6[5],
                                                       (cycles, n_f))))
    for inj, keys in ((inj_f, keys6), (inj_h, keys5)):
        assert np.array_equal(inj[0].numpy(), np.asarray(
            jax.random.bernoulli(keys[0], np.float32(0.4), (cycles, 16))))
    assert prng.uniform(prng.split(prng.key(seed, "cpu"), 6)[5],
                        (cycles, n_f)).dtype == torch.float32
    with pytest.raises(ValueError, match="fault count"):
        t_sim.draw_streams([healthy, faulted], 16, cycles, "cpu")


def test_repair_restores_delivery_as_in_the_reference():
    """§5.1: re-morphing around dead links wins delivered fraction back,
    with the same numbers in both packages."""
    fr, ft = _pair(lambda m, t: m.sample_faults(t, n_dead_links=3, seed=0),
                   "flat_mesh")
    kw = dict(cycles=200, warmup=0, inj_rate=0.1, seed=2)
    faulted = _both("flat_mesh", (fr, ft), **kw)
    rr = r_faults.suggest_repair_morph(r_spec.TopologySpec("flat_mesh", 16),
                                       fr).faults
    repaired = _both("flat_mesh", None, topo_faults=(rr, ft), **kw)
    assert repaired.reachability == 1.0 > faulted.reachability
    assert repaired.delivered_fraction > faulted.delivered_fraction


def _stall_exps(mod, trace_mod, exp_mod, spec, strict, watchdog, **budget):
    trace = trace_mod.from_records(16, [[(0, 1, 4), (2, 3, 4)],
                                        [(0, 8, 4)]])
    return exp_mod.Experiment(
        topology=spec, traffic=trace,
        budget=exp_mod.Budget(cycles=800, warmup=0, strict_barrier=strict,
                              watchdog=watchdog, **budget),
        inj_rate=1.0, faults=mod.FaultSpec(dead_routers=(0,)))


def test_watchdog_stall_and_lenient_completion_match_reference():
    """The fault_trace_watchdog demo: strict barriers stall phase 1 at
    cycle 74 with 4 unretired credits (``phase_done = [5, -76]``); lenient
    barriers retire the 4 drops and complete (``[5, 10]``).  Both equal
    the reference JSON; the strict Report loads in either package."""
    with open(REFERENCE) as f:
        want = {p["mode"]: p for p in json.load(f)["watchdog"]}
    spec = t_spec.TopologySpec("ring_mesh", 16, src_queue_depth=8)
    got = {}
    for mode, strict, wd in (("strict", True, 64), ("lenient", False, 0)):
        rep = _stall_exps(t_faults, t_tr, t_exp, spec, strict, wd,
                          **CPU).run()
        got[mode] = rep
        d = _fields(rep.sim)
        d["phase_done"] = list(d["phase_done"])
        assert d == {k: v for k, v in want[mode].items() if k != "mode"}
    s, le = got["strict"].sim, got["lenient"].sim
    assert (list(s.phase_done), s.stalled_phase, s.stall_cycle,
            s.stall_unretired) == ([5, -76], 1, 74, 4)
    assert not s.trace_completed and "stalled_phase" in s.row()
    assert list(le.phase_done) == [5, 10] and le.dropped == 4
    assert le.trace_completed and le.stalled_phase == -1
    text = got["strict"].to_json()
    assert t_exp.Report.from_json(text) == got["strict"]
    back = r_exp.Report.from_json(text.replace('"backend": "torch"',
                                               '"backend": "xla"'))
    assert back.sim.phase_done == s.phase_done
    assert back.sim.stall_unretired == 4


def test_watchdog_matches_reference_on_a_healthy_trace():
    """The reference test's two-phase trace (watchdog 48): the healthy run
    completes and the faulted strict run stalls, identically."""
    recs = [[(0, 1, 4)], [(0, 8, 4)]]
    for flt in (None, (r_faults.FaultSpec(dead_routers=(0,)),
                       t_faults.FaultSpec(dead_routers=(0,)))):
        rx = r_sim.simulate(
            r_spec.TopologySpec("ring_mesh", 16).build(),
            r_sim.SimConfig(cycles=200, warmup=0, inj_rate=1.0,
                            pattern=r_tr.from_records(16, recs),
                            strict_barrier=True, watchdog=48,
                            faults=flt and flt[0]))
        rt = t_sim.simulate(
            t_spec.TopologySpec("ring_mesh", 16).build(),
            t_sim.SimConfig(cycles=200, warmup=0, inj_rate=1.0,
                            pattern=t_tr.from_records(16, recs),
                            strict_barrier=True, watchdog=48,
                            faults=flt and flt[1], **CPU))
        assert _fields(rt) == _fields(rx)
        assert rt.trace_completed == (flt is None)


def test_fault_grid_batches_and_matches_per_point_and_reference():
    """A fault grid runs as few batches (healthy points and each fault
    bucket apart), each point equal to its per-point run and to the
    reference's sweep."""
    rt = r_spec.TopologySpec("ring_mesh", 16).build()
    tt = t_spec.TopologySpec("ring_mesh", 16).build()
    kws = (dict(n_dead_links=2, seed=0), dict(n_dead_links=4, seed=1),
           dict(n_transient=2, seed=2))
    rf = (None,) + tuple(r_faults.sample_faults(rt, **k) for k in kws)
    tf = (None,) + tuple(t_faults.sample_faults(tt, **k) for k in kws)
    grid = dict(inj_rates=(0.2, 0.4), seeds=(0,), cycles=200, warmup=0)
    rcfgs = r_sweep.grid(faults=rf, **grid)
    tcfgs = t_sweep.grid(faults=tf, **CPU, **grid)
    assert len(t_sweep._grouped(tt, tcfgs)) == 2
    rr = r_sweep.sweep(rt, rcfgs)
    tr_ = t_sweep.sweep(tt, tcfgs)
    assert [_fields(a) for a in tr_] == [_fields(b) for b in rr]
    for cfg, rb in zip(tcfgs[:4], tr_[:4]):
        assert rb == t_sim.simulate(tt, cfg)


def test_experiment_fault_axis_and_report_json_both_ways():
    fr, ft = _pair(lambda m, t: m.sample_faults(t, n_dead_links=2, seed=0))
    rr = r_exp.Experiment(topology=r_spec.TopologySpec("ring_mesh", 16),
                          budget=r_exp.Budget(cycles=200, warmup=0),
                          inj_rate=0.2).run_grid(faults=(None, fr))
    tt = t_exp.Experiment(topology=t_spec.TopologySpec("ring_mesh", 16),
                          budget=t_exp.Budget(cycles=200, warmup=0, **CPU),
                          inj_rate=0.2).run_grid(faults=(None, ft))
    assert tt[0].reachability == 1.0 > tt[1].reachability
    assert tt[1].latency_inflation(tt[0]) == rr[1].latency_inflation(rr[0])
    for rrep, trep in zip(rr, tt):
        assert trep.row() == rrep.row()
        rd, td = json.loads(rrep.to_json()), json.loads(trep.to_json())
        for d in (rd, td):
            d["experiment"]["budget"]["backend"] = "x"
            d["sim"]["cfg"]["backend"] = "x"
        assert td == rd
        assert t_exp.Report.from_json(trep.to_json()) == trep
        assert r_exp.Report.from_json(trep.to_json().replace(
            '"backend": "torch"', '"backend": "xla"')) == rrep


@pytest.mark.cuda
def test_cuda_fault_mode_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    topo = t_spec.TopologySpec("flat_mesh", 64).build()
    flts = (None, t_faults.sample_faults(topo, n_dead_links=4, seed=1),
            t_faults.sample_faults(topo, n_dead_links=1, n_transient=2,
                                   drop_p=0.4, onset=200, seed=2))
    out = {}
    for backend in ("cuda", "torch"):
        out[backend] = t_sweep.sweep(topo, t_sweep.grid(
            inj_rates=(0.3,), seeds=(0, 5), cycles=500, warmup=0,
            backend=backend, device="cuda", faults=flts))
    assert ([_fields(a) for a in out["cuda"]]
            == [_fields(b) for b in out["torch"]])
