"""The port's static analysis vs the reference's, on the CPU.

* ``repro_torch.analysis.fabric`` (walks on ``device="cpu"``) against
  ``repro.analysis.fabric``: certificates equal as JSON (``elapsed_ms``
  aside), witnesses and their order included, over the fabric cases of
  tests/test_analysis.py — base fabrics, morph overlays, the cyclic ring
  bypass, seeded route-table defects, repaired fabrics, the BFS-refill
  cycle — the config grid up to 64 PEs with its morphs and repairs, and
  ``tests/data/torch_port_fabric_reference.json`` up to 256 PEs; the
  walks themselves (``walk_terminals``; ``core.topology``'s
  ``walk_classify`` on every row, and ``reroute_avoiding``), the cache,
  the pre-flights of ``Experiment`` and ``sweep``, ``measure_repair``'s
  whole dict and the CLI.
* ``repro_torch.analysis.lint_torch``: seeded TORCH001 / TORCH002 /
  TORCH004 caught, cold code and cold parts of hot functions not
  flagged, the allowlist, the CLI, and the port itself clean.

Tolerance: exact.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.analysis import fabric as r_fabric
from repro.core import experiment as r_exp
from repro.core import spec as r_spec
from repro.core import topology as r_topo
from repro import faults as r_faults
from repro_torch.analysis import fabric, lint_torch
from repro_torch.core import experiment as t_exp
from repro_torch.core import spec as t_spec
from repro_torch.core import sweep as t_sweep
from repro_torch.core import topology as t_topo
from repro_torch import faults as t_faults

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "tests", "data",
                         "torch_port_fabric_reference.json")
CPU = "cpu"
T_BUDGET = t_exp.Budget(cycles=200, warmup=0, backend="torch", device=CPU)

# A ring-direction bypass wraps ring hops around the dateline: a genuine
# routing loop AND a dependency cycle — the certifier's canonical reject.
CYCLIC = ((0, 3, (1, 1, 0, 0, 0, 0, 0, 0)),)
SAFE = ((1, 1, (1, 1, 0, 0, 0, 0, 0, 0)),)


def _specs(family="ring_mesh", n=16, morphs=(), faults=None):
    """The same spec in both packages (``faults`` a (ref, port) pair)."""
    return tuple(
        mod.TopologySpec(family, n, morphs=tuple(
            mod.MorphOverlay(hl=h, target=t, link_states=s)
            for h, t, s in morphs), faults=faults and faults[i])
        for i, mod in enumerate((r_spec, t_spec)))


def _sampled(family, n, n_dead_links, seed):
    """(reference, port) repaired specs with sampled dead links."""
    rs, ts = _specs(family, n)
    return _specs(family, n, faults=(
        r_faults.sample_faults(rs.build(), n_dead_links=n_dead_links,
                               seed=seed),
        t_faults.sample_faults(ts.build(), n_dead_links=n_dead_links,
                               seed=seed)))


def _d(cert) -> dict:
    d = cert.to_dict()
    del d["elapsed_ms"]
    return d


def _both(rs, ts):
    """Certify a spec pair uncached; assert equal; return the port's."""
    want = r_fabric.certify(rs, use_cache=False)
    got = fabric.certify(ts, use_cache=False, device=CPU)
    assert _d(got) == _d(want)
    assert got.summary().split(" (")[0] == want.summary().split(" (")[0]
    return got


# ---------------------------------------------------------------------------
# Certification: pristine fabrics, cache, target types
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
@pytest.mark.parametrize("n", [16, 64])
def test_base_fabrics_certify_equal(family, n):
    cert = _both(*_specs(family, n))
    assert cert.ok and all(cert.prop(p).ok for p in fabric.PROPERTIES)
    assert not cert.prop("vc_discipline").waived   # pristine: required
    live = cert.prop("route_liveness").data
    assert live["severed"] == 0 and live["looped"] == 0
    assert live["reachable_frac"] == 1.0


def test_certificate_counts_and_spec_recorded():
    _, ts = _specs()
    cert = fabric.certify(ts, use_cache=False, device=CPU)
    t = ts.build()
    assert cert.n_pairs >= t.n_pes ** 2
    assert cert.n_edges > 0 and cert.n_links == t.n_links
    assert cert.spec == ts.to_dict() == _specs()[0].to_dict()
    assert "CERTIFIED" in cert.summary()


def test_certify_cache_hits_on_spec():
    _, ts = _specs()
    fabric.clear_certificate_cache()
    c1 = fabric.certify(ts, device=CPU)
    c2 = ts.certify(device=CPU)
    assert c1 is c2 and fabric.certificate_cache_size() == 1
    # Bare Topology targets are never cached (mutable route table).
    fabric.certify(ts.build(), device=CPU)
    assert fabric.certificate_cache_size() == 1
    if not torch.cuda.is_available():
        # The device is checked before the cache: no quiet fallback.
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.certify()
    fabric.clear_certificate_cache()


def test_certify_rejects_unknown_target():
    with pytest.raises(TypeError, match="TopologySpec or Topology"):
        fabric.certify("ring_mesh_16", device=CPU)


# ---------------------------------------------------------------------------
# Certification: morph overlays
# ---------------------------------------------------------------------------
def test_safe_morphs_certify_with_waived_vc():
    cert = _both(*_specs("ring_mesh", 64, SAFE))
    assert cert.ok and cert.prop("vc_discipline").waived
    assert cert.prop("route_liveness").data["severed_violating"] == 0


def test_cyclic_ring_bypass_rejected_with_cycle_witness():
    rs, ts = _specs("ring_mesh", 16, CYCLIC)
    cert = _both(rs, ts)
    assert not cert.ok and "REJECTED" in cert.summary()
    w = cert.prop("deadlock_free").witness[0]
    assert w["kind"] == "cycle" and len(w["queues"]) >= 2
    # The witness is a real cycle of realizable dependency edges, and the
    # port's edge arrays are the reference's, in its order.
    _, esrc, edst = fabric.occupancy_edges(ts.build(), device=CPU)
    _, r_src, r_dst = r_fabric.occupancy_edges(rs.build())
    assert np.array_equal(esrc.numpy(), r_src)
    assert np.array_equal(edst.numpy(), r_dst)
    edges = set(zip(esrc.tolist(), edst.tolist()))
    qs = w["queues"]
    for a, b in zip(qs, qs[1:] + qs[:1]):
        assert (a, b) in edges, (qs, (a, b))
    live = cert.prop("route_liveness")
    assert live.data["looped"] > 0
    assert any(v["kind"] == "loop" and v["queues"] for v in live.witness)


def test_require_certified_raises_with_certificate():
    _, ts = _specs("ring_mesh", 16, CYCLIC)
    with pytest.raises(fabric.CertificationError) as ei:
        fabric.require_certified(ts, use_cache=False, device=CPU)
    assert not ei.value.certificate.ok
    assert "REJECTED" in str(ei.value)


# ---------------------------------------------------------------------------
# Certification: seeded route-table defects (bare Topology)
# ---------------------------------------------------------------------------
def _loop_seeded(topo, dst=15, src=0):
    """Mutate ``topo`` so the src->dst walk falls into a 3-queue cycle;
    returns the cycle's queues."""
    q = int(topo.pe_src_link[src])
    walk = []
    while True:
        q = int(topo.route_table[q, dst])
        if topo.is_sink[q]:
            break
        walk.append(q)
    topo.route_table[walk[-1], dst] = walk[-3]
    return walk[-3:]


def _severed(topo, dst=15):
    q = int(topo.route_table[topo.pe_src_link[0], dst])
    topo.route_table[q, dst] = t_topo.INVALID
    return q


def _non_node_local(topo):
    # Point a mesh queue at a queue leaving a *different* node: breaks the
    # structural fan-in invariant even if the walk still terminates.
    q = int(np.nonzero(topo.link_kind == t_topo.MESH)[0][0])
    node = topo.link_dst_node[q]
    alien = int(np.nonzero((topo.link_src_node != node)
                           & (topo.link_kind == t_topo.MESH))[0][0])
    topo.route_table[q, :] = alien
    return q


DEFECTS = {"cycle": ("ring_mesh", _loop_seeded),
           "severed": ("ring_mesh", _severed),
           "non_node_local": ("flat_mesh", _non_node_local)}


@pytest.mark.parametrize("defect", sorted(DEFECTS))
def test_seeded_defect_caught_with_reference_witness(defect):
    family, seed = DEFECTS[defect]
    rs, ts = _specs(family)
    rt, tt = rs.build_fresh(), ts.build_fresh()
    assert seed(rt) == seed(tt)
    got = fabric.certify_topology(tt, device=CPU)
    assert _d(got) == _d(r_fabric.certify_topology(rt))
    assert not got.ok
    if defect == "cycle":
        cycle = _loop_seeded(ts.build_fresh())
        assert set(got.prop("deadlock_free").witness[0]["queues"]) == \
            set(cycle)
        found = fabric.dependency_cycle(tt, device=CPU)
        assert found == r_fabric.dependency_cycle(rt)
        assert set(found) == set(cycle)
        loops = [w for w in got.prop("route_liveness").witness
                 if w["kind"] == "loop"]
        assert loops and any(w["dst"] == 15 for w in loops)
        for w in loops:
            qs = w["queues"]
            assert qs == fabric.extract_route_loop(tt, qs[0], w["dst"])
            for a, b in zip(qs, qs[1:] + qs[:1]):
                assert int(tt.route_table[a, w["dst"]]) == b
    elif defect == "severed":
        live = got.prop("route_liveness")
        assert live.data["severed_violating"] > 0
        assert any(w["kind"] == "severed" and w["dst"] == 15
                   for w in live.witness)
    else:
        cons = got.prop("table_consistency")
        assert cons.data["non_node_local"] > 0
        assert any(w["kind"] == "non_node_local" for w in cons.witness)


@pytest.mark.parametrize("case", ["ring_mesh_16", "cyclic_morph",
                                  "repaired_flat_64"])
def test_walk_terminals_equal_reference_and_walk_classify(case):
    rs, ts = {"ring_mesh_16": _specs(),
              "cyclic_morph": _specs("ring_mesh", 16, CYCLIC),
              "repaired_flat_64": _sampled("flat_mesh", 64, 4, 0)}[case]
    rt, tt = rs.build(), ts.build()
    term = fabric.walk_terminals(tt.route_table, tt.is_sink,
                                 tt.dead_queues, device=CPU)
    assert term.dtype == torch.int32 and term.device.type == CPU
    want = r_fabric.walk_terminals(rt.route_table, rt.is_sink,
                                   rt.dead_queues)
    assert np.array_equal(term.numpy(), want)
    # On the (src, dst) surface a walk delivers to a sink exactly when the
    # port's walk_classify says the pair is live.
    ok = t_topo.walk_classify(tt.route_table, tt.is_sink, tt.dead_queues)
    src_term = term.numpy()[tt.pe_src_link]
    sink_ext = np.concatenate([tt.is_sink, [False]])
    delivered = sink_ext[np.clip(src_term, 0, tt.n_links)]
    assert np.array_equal(delivered, ok[tt.pe_src_link])
    occ, _, _ = fabric.occupancy_edges(tt, device=CPU)
    assert np.array_equal(occ.numpy(), r_fabric.occupancy_edges(rt)[0])


@pytest.mark.parametrize("case", ["ring_mesh_16", "ring_mesh_64",
                                  "flat_mesh_64", "cyclic_morph",
                                  "repaired_ring_64"])
def test_walk_classify_and_reroute_equal_reference(case):
    """The port's walk (torch pointer doubling) against the reference's
    numpy walk on every (queue, dest) row, with no dead mask, the fabric's
    own dead queues and a sampled one; and ``reroute_avoiding`` around the
    sampled mask (the repaired fabric: around its own dead queues)."""
    rs, ts = {"ring_mesh_16": _specs(),
              "ring_mesh_64": _specs("ring_mesh", 64),
              "flat_mesh_64": _specs("flat_mesh", 64),
              "cyclic_morph": _specs("ring_mesh", 16, CYCLIC),
              "repaired_ring_64": _sampled("ring_mesh", 64, 4, 2)}[case]
    rt, tt = rs.build_fresh(), ts.build_fresh()
    assert np.array_equal(tt.route_table, rt.route_table)
    if tt.dead_queues is not None:
        dead = tt.dead_queues
    else:
        dead = t_faults.sample_faults(tt, n_dead_links=3,
                                      seed=5).dead_queue_mask(tt)
        assert np.array_equal(dead, r_faults.sample_faults(
            rt, n_dead_links=3, seed=5).dead_queue_mask(rt))
    assert dead.any()
    for mask in (None, tt.dead_queues, dead):
        got = t_topo.walk_classify(tt.route_table, tt.is_sink, mask)
        want = r_topo.walk_classify(rt.route_table, rt.is_sink, mask)
        assert got.dtype == want.dtype == np.bool_
        assert np.array_equal(got, want)
    if case == "cyclic_morph":
        # The bypass's loops never reach a sink: those pairs read BAD.
        assert not t_topo.walk_classify(tt.route_table, tt.is_sink).all()
    route, reach = t_topo.reroute_avoiding(tt, dead)
    want_route, want_reach = r_topo.reroute_avoiding(rt, dead)
    assert route.dtype == want_route.dtype
    assert np.array_equal(route, want_route)
    assert np.array_equal(reach, want_reach)


# ---------------------------------------------------------------------------
# Certification: fault-repaired fabrics
# ---------------------------------------------------------------------------
def test_repaired_fabric_certifies_against_declared_reachability():
    cert = _both(*_sampled("ring_mesh", 64, 4, 0))
    assert cert.ok
    live = cert.prop("route_liveness").data
    assert live["declared_reachability"]
    assert live["severed_violating"] == 0
    assert live["undeclared_delivery"] == 0
    assert cert.prop("vc_discipline").waived   # repairs break the dateline


def test_bfs_refill_cycle_is_caught():
    # BFS route refill can violate XY ordering and re-introduce a
    # dependency cycle (flat_mesh 64, 4 dead links, seed 3).
    cert = _both(*_sampled("flat_mesh", 64, 4, 3))
    dead = cert.prop("deadlock_free")
    assert not cert.ok and not dead.ok and dead.witness[0]["queues"]


def test_measure_repair_equals_reference():
    rs, ts = _specs()
    r_flt = r_faults.sample_faults(rs.build(), n_dead_links=2, seed=0)
    t_flt = t_faults.sample_faults(ts.build(), n_dead_links=2, seed=0)
    got = t_faults.measure_repair(ts, t_flt, budget=t_exp.Budget(
        cycles=300, warmup=0, backend="torch", device=CPU))
    want = r_faults.measure_repair(rs, r_flt,
                                   budget=r_exp.Budget(cycles=300, warmup=0))
    assert got == want
    cert = got["certified"]
    assert set(cert) == {"ok", "deadlock_free", "route_liveness", "witness"}
    assert cert["ok"] and cert["deadlock_free"] and not cert["witness"]


# ---------------------------------------------------------------------------
# Serialization, shims, pre-flights, CLI
# ---------------------------------------------------------------------------
def test_certificate_json_roundtrip():
    for morphs in ((), CYCLIC):
        cert = fabric.certify(_specs("ring_mesh", 16, morphs)[1],
                              use_cache=False, device=CPU)
        back = fabric.FabricCertificate.from_json(cert.to_json())
        assert back.to_dict() == cert.to_dict() and back.ok == cert.ok
        assert [p.witness for p in back.properties] == \
            [p.witness for p in cert.properties]
        # The reference loads the port's JSON into the same record.
        ref = r_fabric.FabricCertificate.from_json(cert.to_json())
        assert ref.to_dict() == cert.to_dict()


def test_check_deadlock_free_shim_and_hops_witness():
    rs, ts = _specs()
    assert ts.build().check_deadlock_free(device=CPU)
    rt, tt = rs.build_fresh(), ts.build_fresh()
    cycle = _loop_seeded(tt)
    _loop_seeded(rt)
    assert not tt.check_deadlock_free(device=CPU)
    assert not rt.check_deadlock_free()
    with pytest.raises(RuntimeError, match="queue cycle") as ei:
        tt.hops(0, 15)
    with pytest.raises(RuntimeError, match="queue cycle") as ri:
        rt.hops(0, 15)
    assert str(ei.value) == str(ri.value) and str(cycle[0]) in str(ei.value)


def test_experiment_verify_preflight():
    _, ts = _specs()
    exp = t_exp.Experiment(topology=ts, budget=T_BUDGET, verify=True)
    assert exp.to_dict()["verify"]
    assert "verify" not in t_exp.Experiment(topology=ts,
                                            budget=T_BUDGET).to_dict()
    with pytest.raises(fabric.CertificationError):
        t_exp.Experiment(topology=_specs("ring_mesh", 16, CYCLIC)[1],
                         budget=T_BUDGET, verify=True)


def test_sweep_verify_preflight():
    _, ts = _specs()
    cfg = t_exp.Experiment(topology=ts, budget=T_BUDGET).sim_config()
    assert len(t_sweep.sweep(ts.build(), [cfg], verify=True)) == 1
    bad = ts.build_fresh()
    _loop_seeded(bad)
    with pytest.raises(fabric.CertificationError):
        t_sweep.sweep(bad, [cfg], verify=True)   # raises before any run
    assert len(t_sweep.sweep_grid(ts.build(), verify=True, cycles=60,
                                  warmup=0, backend="torch",
                                  device=CPU)) == 1


def test_fabric_cli_single_family(capsys):
    argv = ["--family", "ring_mesh", "--pes", "16", "--device", CPU]
    assert fabric.main(argv) == 0
    assert "CERTIFIED" in capsys.readouterr().out
    assert fabric.main(argv + ["--json"]) == 0
    out = capsys.readouterr().out
    cert = json.loads(out[:out.rindex("}") + 1])
    assert cert["ok"] and cert["topology"] == "ring_mesh_16"


_GRID = [spec for _, spec in r_fabric._config_targets(64, True, True)]


def test_config_grid_targets_equal_reference():
    got = fabric._config_targets(64, True, True)
    want = r_fabric._config_targets(64, True, True)
    assert [(label, s.to_dict()) for label, s in got] == \
        [(label, s.to_dict()) for label, s in want]
    assert len(got) == len(_GRID) == 10


@pytest.mark.parametrize("i", range(len(_GRID)))
def test_config_grid_certifies_equal(i):
    label, ts = fabric._config_targets(64, True, True)[i]
    assert _both(_GRID[i], ts).ok, label


def test_certificates_equal_reference_file():
    """Every fabric of the reference file up to 256 PEs (the card holds
    the rest, chip_smoke.py phase 12)."""
    with open(REFERENCE) as f:
        ref = json.load(f)
    n = 0
    for e in ref["certificates"]:
        want = e["certificate"]
        if want["n_pes"] > 256:
            continue
        spec = t_spec.TopologySpec.from_dict(want["spec"])
        assert spec.to_dict() == want["spec"]
        got = fabric.certify(spec, use_cache=False, device=CPU)
        assert _d(got) == want, (e["label"], want["topology"])
        n += 1
    assert n == 19
    labels = {e["label"] for e in ref["certificates"]}
    assert labels == {"config", "morph", "repair", "fault_recipe_repair",
                      "bfs_refill_cycle"}


# ---------------------------------------------------------------------------
# lint_torch: seeded violations
# ---------------------------------------------------------------------------
_SEEDED_HOT = '''
import torch

def cycle_step(state, inj_rate: float, n: int):
    total = state.sum()
    if inj_rate > 0.5:              # TORCH002: tensor-typed param
        total = total + 1
    x = float(total)                # TORCH001: reads a tensor back
    y = state.cpu()                 # TORCH001
    z = state.mean().item()         # TORCH001
    w = state.tolist()              # TORCH001
    v = state.numpy()               # TORCH001
    torch.cuda.synchronize()        # TORCH001
    if n > 3:                       # exempt: int-annotated param
        total = total * 2
    if state is None:               # exempt: structure, not a value
        return 0
    if state.shape[0] > 2 and n:    # exempt: shape arithmetic
        total = total + n
    return x, y, z, w, v, int(state.shape[1])
'''


def test_lint_catches_seeded_hot_path_violations():
    fs = lint_torch.lint_source(_SEEDED_HOT, "seeded.py")
    assert [f.rule for f in fs] == ["TORCH002"] + ["TORCH001"] * 6
    assert all(f.qualname == "cycle_step" for f in fs)
    assert "inj_rate" in fs[0].message
    assert [f.line for f in fs] == [6, 8, 9, 10, 11, 12, 13]
    assert all("seeded.py:" in f.render() for f in fs)


def test_lint_cold_functions_not_flagged():
    src = '''
def summarize(state):
    if state.any():
        return float(state.mean().item())   # fine: not a hot path
'''
    assert lint_torch.lint_source(src) == []


_SCOPES = '''
def run_plain(geom, inj, *, cycles: int):
    n = int(inj.sum())                 # before the loop: cold
    for c in range(int(inj.shape[1])):
        k = inj[:, c].item()           # the per-cycle loop: hot
    while bool(inj.any()):             # a while loop's test: hot
        inj = inj[1:]
    return inj.cpu()                   # the readout after it: cold

def forward(cfg, params, tokens):
    def inner(x):
        return x.tolist()              # nested in a hot function: hot
    return inner(tokens)

def mamba_block(cfg, p, x, *, cross: bool = False, memory=None):
    if cross or memory is not None:    # exempt operands, one by one
        return x
    return x.numpy()

def helper_kernel(x):
    return x.item()
'''

_SCOPE_CASES = {
    "kernels/noc_step.py": [("TORCH001", "run_plain", 5),
                            ("TORCH001", "run_plain", 6),
                            ("TORCH002", "run_plain", 6)],
    "models/model.py": [("TORCH001", "forward.inner", 12)],
    "models/layers.py": [("TORCH001", "mamba_block", 18)],
    "serve/engine.py": [],
}


@pytest.mark.parametrize("path", sorted(_SCOPE_CASES))
def test_lint_hot_scopes(path):
    """Which code is hot depends on the module: the twin's per-cycle loop
    in noc_step.py, forward in model.py, the blocks in layers.py;
    ``*_kernel`` everywhere."""
    fs = lint_torch.lint_source(_SCOPES, "src/repro_torch/" + path)
    want = _SCOPE_CASES[path] + [("TORCH001", "helper_kernel", 21)]
    assert [(f.rule, f.qualname, f.line) for f in fs] == want


def test_lint_mutable_dataclass_default():
    src = '''
import dataclasses

@dataclasses.dataclass(frozen=True)
class Spec:
    xs: list = []
    ok: tuple = ()
'''
    fs = lint_torch.lint_source(src)
    assert [f.rule for f in fs] == ["TORCH004"]
    assert fs[0].qualname == "Spec"


# ---------------------------------------------------------------------------
# lint_torch: allowlist, CLI, the port itself
# ---------------------------------------------------------------------------
def test_lint_allowlist_silences_audited_findings(tmp_path):
    mod = tmp_path / "seeded.py"
    mod.write_text(_SEEDED_HOT)
    allow = tmp_path / "allow.txt"
    allow.write_text("# audited: test fixture\n"
                     "seeded.py:TORCH001:cycle_step\n")
    reported, silenced = lint_torch.lint_paths([str(mod)],
                                               allowlist=str(allow))
    assert [f.rule for f in reported] == ["TORCH002"]
    assert len(silenced) == 6
    reported, silenced = lint_torch.lint_paths([str(mod)], allowlist=None)
    assert len(reported) == 7 and not silenced


def test_lint_allowlist_rejects_malformed_line(tmp_path):
    bad = tmp_path / "allow.txt"
    bad.write_text("just-a-path\n")
    with pytest.raises(ValueError, match="bad allowlist line"):
        lint_torch.load_allowlist(str(bad))


def test_lint_cli_fails_on_seeded_hot_sync(tmp_path, capsys):
    mod = tmp_path / "hot.py"
    mod.write_text(_SEEDED_HOT)
    assert lint_torch.main([str(mod), "--no-allowlist"]) == 1
    out = capsys.readouterr().out
    assert "TORCH001" in out and ".item()" in out
    clean = tmp_path / "cold.py"
    clean.write_text("def helper(x):\n    return x.item()\n")
    assert lint_torch.main([str(clean)]) == 0


def test_lint_port_is_clean():
    """``src/repro_torch`` and ``chip_smoke.py`` lint clean modulo the
    audited allowlist, and every allowlist entry silences a real finding
    and carries its reason."""
    paths = [os.path.join(ROOT, "src", "repro_torch"),
             os.path.join(ROOT, "chip_smoke.py")]
    reported, silenced = lint_torch.lint_paths(paths)
    assert reported == [], "\n".join(f.render() for f in reported)
    allow = lint_torch.load_allowlist(lint_torch.DEFAULT_ALLOWLIST)
    for entry in allow:
        assert any(lint_torch._allowed(f, [entry]) for f in silenced), entry
    with open(lint_torch.DEFAULT_ALLOWLIST) as f:
        blocks = f.read().split("\n\n")
    for entry in allow:
        block = next(b for b in blocks if ":".join(entry) in b)
        assert block.lstrip().startswith("#"), entry
