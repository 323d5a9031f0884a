"""The port's simulator vs the reference's, end to end on the CPU.

``repro_torch.core.sim.simulate`` (the plain twin, ``backend="torch"`` on
the CPU) must equal ``repro.core.sim.simulate(backend="xla")`` field for
field over the matrix of tests/test_noc_kernel.py: both families x queue
regimes from empty to saturated, 64 PEs under the paper's locality, a morph
overlay, a repaired fabric and the per-kind diagnostics.  The seed alone
drives both, so this also holds the port's random streams.  Tolerance:
exact.  The 64-PE points of ``tests/data/torch_port_reference.json`` (the
figs15_17 recipe, written by tests/make_torch_port_reference.py) must
reproduce too.
"""
import dataclasses
import json
import os
import weakref

import numpy as np
import pytest
import torch

from repro.core import sim as r_sim
from repro.core import spec as r_spec
from repro.faults import spec as r_faults
from repro_torch import telemetry
from repro_torch.configs.ringmesh_noc import CONFIG
from repro_torch.core import experiment as t_exp
from repro_torch.core import morph as t_morph
from repro_torch.core import packet as t_pk
from repro_torch.core import sim as t_sim
from repro_torch.core import spec as t_spec
from repro_torch.core import topology as t_topo
from repro_torch.faults import spec as t_faults

torch.set_num_threads(1)

CYCLES, WARMUP = 300, 100
REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "torch_port_reference.json")
MORPH = dict(hl=1, target=0, link_states=(0, 0, 0, 0, 2, 0, 0, 0))


def _fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name != "cfg"}


def _both(rspec, tspec, **cfg_kw):
    rx = r_sim.simulate(rspec.build(),
                        r_sim.SimConfig(backend="xla", **cfg_kw))
    rt = t_sim.simulate(tspec.build(),
                        t_sim.SimConfig(backend="torch", device="cpu",
                                        **cfg_kw))
    assert _fields(rt) == _fields(rx), (cfg_kw, rx.row(), rt.row())
    assert rt.lost == 0
    return rx, rt


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
@pytest.mark.parametrize("rate,pattern,seed", [
    (0.0, "uniform", 0), (0.25, "uniform", 1),
    (0.9, "transpose", 2), (1.0, "hotspot", 3)])
def test_simulate_matches_reference(family, rate, pattern, seed):
    _, rt = _both(r_spec.TopologySpec(family, 16),
                  t_spec.TopologySpec(family, 16), cycles=CYCLES,
                  warmup=WARMUP, inj_rate=rate, pattern=pattern, seed=seed)
    if rate >= 1.0:
        assert rt.dropped > 0  # saturated: back-pressure drops


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_simulate_matches_reference_64_locality(family):
    _both(r_spec.TopologySpec(family, 64), t_spec.TopologySpec(family, 64),
          cycles=CYCLES, warmup=WARMUP, inj_rate=0.6, pattern="uniform",
          seed=7, **t_sim.PAPER_LOCALITY)


def test_simulate_matches_reference_with_morph_overlay():
    _, rt = _both(
        r_spec.TopologySpec("ring_mesh", 16,
                            morphs=(r_spec.MorphOverlay(**MORPH),)),
        t_spec.TopologySpec("ring_mesh", 16,
                            morphs=(t_spec.MorphOverlay(**MORPH),)),
        cycles=CYCLES, warmup=WARMUP, inj_rate=0.3, seed=4)
    assert rt.dropped > 0  # the overlay is actually in effect


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_simulate_matches_reference_on_repaired_fabric(family):
    rs, ts = r_spec.TopologySpec(family, 16), t_spec.TopologySpec(family, 16)
    fr = r_faults.sample_faults(rs.build(), n_dead_links=3, seed=6)
    ft = t_faults.sample_faults(ts.build(), n_dead_links=3, seed=6)
    _both(dataclasses.replace(rs, faults=fr),
          dataclasses.replace(ts, faults=ft), cycles=CYCLES, warmup=WARMUP,
          inj_rate=0.4, seed=5)


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_kind_diagnostics_match_reference(family):
    cfg = dict(cycles=CYCLES, warmup=WARMUP, inj_rate=0.5, seed=5)
    dx = r_sim.kind_diagnostics(r_spec.TopologySpec(family, 16).build(),
                                r_sim.SimConfig(backend="xla", **cfg))
    dt = t_sim.kind_diagnostics(t_spec.TopologySpec(family, 16).build(),
                                t_sim.SimConfig(backend="torch",
                                                device="cpu", **cfg))
    assert dt == dx
    assert sum(dt["wins_by_kind"].values()) > 0


def test_reference_json_64_pe_points_reproduce():
    with open(REFERENCE) as f:
        ref = json.load(f)
    recipe = ref["recipe"]
    cfg = dataclasses.replace(
        CONFIG, injection_rates=tuple(recipe["injection_rates"]),
        cycles=recipe["cycles"], warmup=recipe["warmup"])
    exps = cfg.experiments(sizes=(64,), seed=recipe["seed"],
                           backend="torch", device="cpu")
    reports = t_exp.run_experiments(exps)
    want = {(p["family"], p["n_pes"], p["pattern"]): p
            for p in ref["points"]}
    for e, r in zip(exps, reports):
        p = want[(e.topology.family, 64, e.traffic.kind)]
        got = {k: getattr(r.sim, k) for k in p
               if k not in ("family", "n_pes", "pattern")}
        assert got == {k: v for k, v in p.items()
                       if k not in ("family", "n_pes", "pattern")}, p
        assert r.sim.lost == 0
    assert len(reports) == 6


def test_config_validation():
    with pytest.raises(ValueError, match="backend"):
        t_sim.SimConfig(backend="xla")
    with pytest.raises(ValueError, match="CUDA device"):
        t_sim.SimConfig(backend="cuda", device="cpu")
    assert t_sim.SimConfig().backend == "cuda"
    assert t_sim.SimConfig().torch_device().type == "cuda"
    # The device is placement, not identity.
    assert (t_sim.SimConfig(backend="torch", device="cpu")
            == t_sim.SimConfig(backend="torch"))
    ts = t_spec.TopologySpec("ring_mesh", 16)
    flt = t_faults.sample_faults(ts.build(), n_dead_links=1, seed=0)
    # Runtime faults are ported: the config builds and keeps its faults.
    assert t_sim.SimConfig(backend="torch", device="cpu",
                           faults=flt).faults == flt
    with pytest.raises(TypeError, match="FaultSpec"):
        t_sim.SimConfig(backend="torch", device="cpu", faults=(1, 2))
    with pytest.raises(ValueError, match="trace-replay"):
        t_sim.SimConfig(backend="torch", device="cpu", watchdog=5)
    with pytest.raises(ValueError, match="warmup"):
        t_sim.SimConfig(cycles=10, warmup=10)


def _morph_walk(topo, repeats=1):
    """The reference's ``test_geometry_morph_aware`` walk on the port: each
    state simulated ``repeats`` times — as built, with ringlet 0 of block 0
    switched off, and reset.  Returns the results and the route array of
    each state."""
    cfg = t_sim.SimConfig(backend="torch", device="cpu", cycles=CYCLES,
                          warmup=WARMUP, inj_rate=0.2, seed=0)
    ctl = t_morph.MorphController(topo)
    runs, arrays = [], []
    for step in ("built", "morphed", "reset"):
        if step == "morphed":
            ctl.apply(t_pk.MorphPacket(hl=1, ers=0,
                                       link_states=MORPH["link_states"]),
                      target=0)
        elif step == "reset":
            ctl.reset()
        runs.append([t_sim.simulate(topo, cfg) for _ in range(repeats)])
        arrays.append(topo.route_table)
    return runs, arrays


def test_geometry_morph_aware():
    """A morph reassigns the route table; the next run must see it, and a
    reset must give the first result back exactly."""
    (before,), (after,), (restored,) = _morph_walk(
        t_spec.TopologySpec("ring_mesh", 16).build_fresh())[0]
    assert after.dropped > before.dropped
    assert restored == before


def test_geometry_uploads_each_route_array_once():
    topo = t_spec.TopologySpec("ring_mesh", 16).build_fresh()
    a = t_sim.build_geometry(topo, "cpu")
    b = t_sim.build_geometry(topo, "cpu")
    assert b.route is a.route
    assert torch.equal(a.route[:-1],
                       torch.from_numpy(topo.route_table.astype(np.int16)))
    assert bool((a.route[-1] == -1).all())
    telemetry.drain()
    telemetry.enable()
    try:
        runs, arrays = _morph_walk(topo, repeats=3)
    finally:
        telemetry.disable()
        out = telemetry.drain()
    assert [len(r) for r in runs] == [3, 3, 3]
    # The reset is a fresh array, equal to the first: identity, not content.
    assert len({id(a) for a in arrays}) == 3
    assert out["counters"][t_sim.ROUTE_UPLOADED] == 2
    assert out["counters"][t_sim.ROUTE_REUSED] == 7
    assert sum(s["name"] == "sim.build_geometry"
               for s in out["spans"]) == 9
    # One entry a device: the statics, the route and the kernel's views.
    entries = topo.__dict__["_torch_geometry_cache"]["devices"]
    assert list(entries) == ["cpu"]
    assert entries["cpu"]["route"][0] is topo.route_table
    assert a.kernel is b.kernel is entries["cpu"]["kernel"]
    assert a.kind is entries["cpu"]["static"]["kind"]


def test_reachability_is_served_only_to_its_own_topology():
    """A reachability entry names its topology by a weak reference: a
    topology at an address that another one held is not served it."""
    topo = t_spec.TopologySpec("ring_mesh", 16).build_fresh()
    other = t_spec.TopologySpec("ring_mesh", 16).build_fresh()
    faults = t_faults.sample_faults(topo, n_dead_links=2, seed=3)
    want = t_sim._fault_reachability(topo, faults)
    assert want < 1.0
    key = (id(topo), faults)
    assert t_sim._REACH_CACHE[key][0]() is topo
    t_sim._REACH_CACHE[key] = (weakref.ref(other), -1.0)  # another's entry
    assert t_sim._fault_reachability(topo, faults) == want
    assert t_sim._REACH_CACHE[key][0]() is topo


def test_route_table_is_read_only_once_uploaded():
    topo = t_spec.TopologySpec("ring_mesh", 16).build_fresh()
    q = int(topo.pe_src_link[0])
    topo.route_table[q, 15] = t_topo.INVALID  # before any upload: allowed
    geom = t_sim.build_geometry(topo, "cpu")
    assert int(geom.route[q, 15]) == t_topo.INVALID
    with pytest.raises(ValueError, match="read-only"):
        topo.route_table[q, 15] = 0
    fixed = topo.route_table.copy()
    fixed[q, 15] = 0
    topo.route_table = fixed  # reassignment: uploaded at the next call
    assert int(t_sim.build_geometry(topo, "cpu").route[q, 15]) == 0
    assert int(geom.route[q, 15]) == t_topo.INVALID
