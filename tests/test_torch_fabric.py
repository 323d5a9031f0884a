"""Host-side fabric model of the PyTorch port vs the JAX reference.

Every ``Topology`` array, every destination map of the traffic registry,
the structural geometry tables and the JSON forms of the specs must be
equal to the reference's, for both families, under morph overlays and on
a fabric with faults repaired into it.  Exact equality: these are integer
tables.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import packet as r_pk
from repro.core import sim as r_sim
from repro.core import spec as r_spec
from repro.core import topology as r_topo
from repro.core import traffic as r_traffic
from repro.faults import spec as r_faults
from repro_torch.core import packet as t_pk
from repro_torch.core import sim as t_sim
from repro_torch.core import spec as t_spec
from repro_torch.core import topology as t_topo
from repro_torch.core import traffic as t_traffic
from repro_torch.faults import spec as t_faults

torch.set_num_threads(1)

FAMILIES = ("ring_mesh", "flat_mesh")
TOPOLOGY_ARRAYS = ("route_table", "link_src_node", "link_dst_node",
                   "link_phys", "link_cap", "link_kind", "link_prio",
                   "link_vc", "is_sink", "pe_src_link", "pe_eject_link")
TOPOLOGY_INTS = ("name", "n_pes", "blocks_x", "blocks_y", "n_links",
                 "n_phys", "n_routers", "n_ringlets")

# The morph overlays of tests/test_noc_kernel.py (router 0's ring port 0
# switched off), tests/test_experiment.py (that plus a ring-switch
# bypass) and tests/test_analysis.py (a ring-direction bypass at 16 PEs,
# a router bypass at 64).
MORPHS = {
    "router_off_16": (16, ((1, 0, (0, 0, 0, 0, 2, 0, 0, 0)),)),
    "router_off_and_bypass_16": (16, ((1, 0, (0, 0, 0, 0, 2, 0, 0, 0)),
                                      (0, 3, (1, 1, 0, 0, 0, 0, 0, 0)))),
    "ring_bypass_16": (16, ((0, 3, (1, 1, 0, 0, 0, 0, 0, 0)),)),
    "router_bypass_64": (64, ((1, 1, (1, 1, 0, 0, 0, 0, 0, 0)),)),
}


def assert_same_topology(rt, tt):
    for name in TOPOLOGY_INTS:
        assert getattr(rt, name) == getattr(tt, name), name
    for name in TOPOLOGY_ARRAYS:
        a, b = np.asarray(getattr(rt, name)), np.asarray(getattr(tt, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("dead_queues", "reachable"):
        a, b = getattr(rt, name), getattr(tt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a, b), name


def _specs(family, n, morphs=(), faults=None):
    rs = r_spec.TopologySpec(family, n, morphs=tuple(
        r_spec.MorphOverlay(hl=h, target=t, link_states=s)
        for h, t, s in morphs), faults=faults and faults[0])
    ts = t_spec.TopologySpec(family, n, morphs=tuple(
        t_spec.MorphOverlay(hl=h, target=t, link_states=s)
        for h, t, s in morphs), faults=faults and faults[1])
    return rs, ts


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [16, 64, 256])
def test_topology_arrays_equal(family, n):
    assert_same_topology(r_topo.build(family, n), t_topo.build(family, n))


@pytest.mark.parametrize("family", FAMILIES)
def test_topology_arrays_equal_1024(family):
    assert_same_topology(r_topo.build(family, 1024),
                         t_topo.build(family, 1024))


@pytest.mark.parametrize("name", sorted(MORPHS))
def test_topology_arrays_equal_under_morphs(name):
    n, morphs = MORPHS[name]
    rs, ts = _specs("ring_mesh", n, morphs)
    assert rs.to_json() == ts.to_json()
    assert_same_topology(rs.build_fresh(), ts.build_fresh())


@pytest.mark.parametrize("family", FAMILIES)
def test_repaired_fabric_equal(family):
    """Faults repaired into the fabric: rerouted tables, dead queues and
    the reachability matrix all match, and so do the sampled faults."""
    healthy_r, healthy_t = _specs(family, 64)
    kw = dict(n_dead_links=3, seed=6)
    fr = r_faults.sample_faults(healthy_r.build(), **kw)
    ft = t_faults.sample_faults(healthy_t.build(), **kw)
    assert fr.to_json() == ft.to_json()
    rs, ts = _specs(family, 64, faults=(fr, ft))
    assert rs.to_json() == ts.to_json()
    rt, tt = rs.build_fresh(), ts.build_fresh()
    assert tt.dead_queues is not None and tt.dead_queues.any()
    assert_same_topology(rt, tt)
    assert rt.reachable_frac == tt.reachable_frac
    dead = ft.dead_queue_mask(healthy_t.build())
    assert (r_topo.reachable_fraction(healthy_r.build(), dead)
            == t_topo.reachable_fraction(healthy_t.build(), dead))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [16, 64])
def test_geometry_tables_equal(family, n):
    """The simulator's structural fan-in tables (``cand``/``intab``) and
    the padded per-row arrays, built by each package from its own
    topology."""
    rg = r_sim.build_geometry(r_topo.build(family, n))
    tg = t_sim.build_geometry(t_topo.build(family, n), "cpu")
    ours = {k: getattr(tg, k).numpy() for k in t_sim.GEOMETRY_ARRAYS}
    for name in t_sim.GEOMETRY_ARRAYS:
        a = np.asarray(getattr(rg, name))
        assert a.dtype == ours[name].dtype, name
        assert np.array_equal(a, ours[name]), name
    for name in ("n_links", "n_phys", "n_pes", "depth", "cap_total"):
        assert getattr(rg, name) == getattr(tg, name), name


# The port's registry kinds.  The reference's registry may hold more in a
# test process (other test files register their own kinds), so the list
# is fixed here.
KINDS = ("bit_reversal", "collective", "hotspot", "shuffle", "tornado",
         "transpose", "uniform")


def test_registry_kinds():
    # The trace kind lives outside core and registers when
    # ``repro_torch.trace`` is first imported (by a test, or lazily by
    # ``resolve``), in both packages.
    import repro_torch.trace  # noqa: F401
    assert t_traffic.names() == tuple(sorted(KINDS + ("trace",)))
    assert set(KINDS) <= set(r_traffic.names())


def _registry_specs(mod):
    return [mod.resolve(kind) for kind in KINDS] + [
        mod.Hotspot(sinks=((1, 2.0), (7, 1.5)), locality_ringlet=0.25),
        mod.Collective(algorithm="halving_doubling", phase=1),
        mod.spec("uniform", locality_ringlet=0.75, locality_block=0.2)]


@pytest.mark.parametrize("n", [16, 64, 256])
def test_destination_maps_equal(n):
    rs, ts = _registry_specs(r_traffic), _registry_specs(t_traffic)
    assert [s.kind for s in rs] == [s.kind for s in ts]
    for a, b in zip(rs, ts):
        assert a.to_json() == b.to_json()
        da, db = a.destinations(n), b.destinations(n)
        assert (da is None) == (db is None), a.kind
        if da is not None:
            assert da.dtype == db.dtype and np.array_equal(da, db), a.kind


def test_spec_json_equal_and_cross_loadable():
    for a, b in zip(_registry_specs(r_traffic), _registry_specs(t_traffic)):
        assert t_traffic.TrafficSpec.from_json(a.to_json()) == b
        assert r_traffic.TrafficSpec.from_json(b.to_json()) == a
    for name, (n, morphs) in MORPHS.items():
        rs, ts = _specs("ring_mesh", n, morphs)
        assert t_spec.TopologySpec.from_json(rs.to_json()) == ts
        assert r_spec.TopologySpec.from_json(ts.to_json()) == rs
    rs = r_spec.TopologySpec("ring_mesh", 64, queue_depth=3,
                             src_queue_depth=8)
    ts = t_spec.TopologySpec("ring_mesh", 64, queue_depth=3,
                             src_queue_depth=8)
    assert rs.to_json() == ts.to_json()


def test_packet_codec_equal():
    for bits in (4, 6, 8, 10):
        x = np.arange(1 << bits)
        assert np.array_equal(r_pk.bitreverse(x, bits),
                              t_pk.bitreverse(x, bits))
        assert np.array_equal(r_pk.transpose_perm(x, bits),
                              t_pk.transpose_perm(x, bits))
    for flat in (0, 5, 17, 255, 1023):
        ra, ta = r_pk.pe_address(flat, 8), t_pk.pe_address(flat, 8)
        assert dataclasses.asdict(ra) == dataclasses.asdict(ta)
        for vc in (0, 1):
            h = r_pk.encode_header(ra, vc)
            assert h == t_pk.encode_header(ta, vc)
            assert r_pk.encode_flit(ra, 0xDEADBEEF, vc) == t_pk.encode_flit(
                ta, 0xDEADBEEF, vc)
    m = dict(hl=1, ers=5, link_states=(0, 1, 2, 0, 0, 1, 0, 2))
    assert (r_pk.MorphPacket(**m).encode()
            == t_pk.MorphPacket(**m).encode())


def test_unported_paths_raise():
    """``certify`` and ``check_deadlock_free`` raised until the fabric
    analysis was ported; now they equal the reference's on the CPU."""
    ts = t_spec.TopologySpec("ring_mesh", 16)
    rs = r_spec.TopologySpec("ring_mesh", 16)
    got, want = ts.certify(device="cpu").to_dict(), rs.certify().to_dict()
    del got["elapsed_ms"], want["elapsed_ms"]
    assert got == want and got["ok"]
    assert ts.build().check_deadlock_free(device="cpu")
    assert rs.build().check_deadlock_free()
    # The trace kind is ported and loads lazily: a bare "trace" names no
    # TraceSpec, so its spec class refuses it.
    with pytest.raises(TypeError, match="TraceSpec"):
        t_traffic.resolve("trace")
