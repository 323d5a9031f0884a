"""The port's sweep engine and experiment API vs the reference's.

* ``sweep``/``run_grid`` (one batch per static key, the batch dimension
  written out) equal per-point ``simulate``;
* ``Report.to_json()`` equals the reference's, field for field, once the
  backend's name is normalized (``"xla"`` there, ``"torch"`` here), for
  the six legacy patterns x 16/64 PEs x both families;
* each package's ``Report.from_json`` loads the other's JSON;
* the numpy power / area / analytic models agree at every size.

All on the CPU with the plain twin (``Budget(backend="torch",
device="cpu")``).  Tolerance: exact.
"""
import dataclasses
import json

import pytest
import torch

from repro.core import analytic as r_analytic
from repro.core import area as r_area
from repro.core import experiment as r_exp
from repro.core import power as r_power
from repro.core import spec as r_spec
from repro.core import topology as r_topo
from repro_torch.core import analytic as t_analytic
from repro_torch.core import area as t_area
from repro_torch.core import experiment as t_exp
from repro_torch.core import power as t_power
from repro_torch.core import sim as t_sim
from repro_torch.core import spec as t_spec
from repro_torch.core import sweep as t_sweep
from repro_torch.core import topology as t_topo
from repro_torch.core import traffic as t_traffic
from repro_torch.faults import spec as t_faults

torch.set_num_threads(1)

R_BUDGET = r_exp.Budget(cycles=300, warmup=100)
T_BUDGET = t_exp.Budget(cycles=300, warmup=100, backend="torch",
                        device="cpu")
SIZES = (16, 64, 128, 256, 512, 1024)


def _normalized(report_json: str, backend: str) -> dict:
    d = json.loads(report_json)
    d["experiment"]["budget"]["backend"] = backend
    d["sim"]["cfg"]["backend"] = backend
    return d


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
@pytest.mark.parametrize("n", [16, 64])
def test_report_json_equals_reference(family, n):
    """Six patterns through each package's ``run_grid``: one batched run
    per geometry on each side, identical reports."""
    rr = r_exp.Experiment(topology=r_spec.TopologySpec(family, n),
                          budget=R_BUDGET, inj_rate=0.35, seed=9)
    tt = t_exp.Experiment(topology=t_spec.TopologySpec(family, n),
                          budget=T_BUDGET, inj_rate=0.35, seed=9)
    rep_r = rr.run_grid(traffics=t_sim.PATTERNS)
    rep_t = tt.run_grid(traffics=t_sim.PATTERNS)
    assert len(rep_r) == len(rep_t) == 6
    for a, b in zip(rep_r, rep_t):
        assert _normalized(a.to_json(), "torch") == json.loads(b.to_json())
        assert b.sim.lost == 0


def test_reports_load_across_packages():
    rr = r_exp.Experiment(topology=r_spec.TopologySpec("ring_mesh", 16),
                          traffic="tornado", budget=R_BUDGET, inj_rate=0.5,
                          seed=2)
    tt = t_exp.Experiment(topology=t_spec.TopologySpec("ring_mesh", 16),
                          traffic="tornado", budget=T_BUDGET, inj_rate=0.5,
                          seed=2)
    rep_r, rep_t = rr.run(), tt.run()
    # Port -> reference, and reference -> port, with the backend renamed.
    back_r = r_exp.Report.from_json(
        json.dumps(_normalized(rep_t.to_json(), "xla")))
    assert back_r == rep_r
    back_t = t_exp.Report.from_json(
        json.dumps(_normalized(rep_r.to_json(), "torch")))
    assert back_t == rep_t
    assert t_exp.Report.from_json(rep_t.to_json()) == rep_t


def test_run_grid_equals_per_point():
    exp = t_exp.Experiment(topology=t_spec.TopologySpec("flat_mesh", 16),
                           budget=T_BUDGET)
    grid = exp.run_grid(inj_rates=(0.25, 0.9), traffics=("uniform",
                                                         "hotspot"),
                        seeds=(0, 3))
    assert len(grid) == 8
    for rep in grid:
        assert rep == rep.experiment.run()


def test_sweep_equals_simulate_and_keeps_order():
    topo = t_spec.TopologySpec("ring_mesh", 16).build()
    cfgs = t_sweep.grid(inj_rates=(0.25, 0.9), patterns=("uniform",
                                                         "tornado"),
                        seeds=(0, 3), cycles=250, warmup=50,
                        backend="torch", device="cpu")
    # A second budget in the middle forms its own group.
    cfgs.insert(3, dataclasses.replace(cfgs[0], cycles=200))
    out = t_sweep.sweep(topo, cfgs)
    for cfg, r in zip(cfgs, out):
        assert r.cfg == cfg
        assert r == t_sim.simulate(topo, cfg)


def test_run_experiments_groups_by_topology():
    specs = [t_spec.TopologySpec("ring_mesh", 16),
             t_spec.TopologySpec("flat_mesh", 16)]
    exps = [t_exp.Experiment(topology=specs[i % 2], budget=T_BUDGET,
                             traffic=t_traffic.spec(
                                 "uniform", **t_sim.PAPER_LOCALITY),
                             inj_rate=0.2 + 0.1 * i, seed=i)
            for i in range(4)]
    reps = t_exp.run_experiments(exps)
    assert [r.experiment for r in reps] == exps
    for r in reps:
        assert r == r.experiment.run()


def test_budget_json_leaves_device_out():
    d = T_BUDGET.to_dict()
    assert d == dataclasses.asdict(dataclasses.replace(
        R_BUDGET, backend="torch"))
    assert t_exp.Budget.from_dict(d) == T_BUDGET
    assert t_exp.Budget().backend == "cuda"


def test_unported_experiment_paths_raise():
    """The paths that raised until the fabric analysis was ported now run:
    the ``verify=True`` pre-flights of ``Experiment`` and ``sweep``
    certify on the budget's device (the CPU here) and change nothing
    else; the default device needs a card and refuses without one."""
    spec = t_spec.TopologySpec("ring_mesh", 16)
    exp = t_exp.Experiment(topology=spec, budget=T_BUDGET, verify=True)
    ref = r_exp.Experiment(topology=r_spec.TopologySpec("ring_mesh", 16),
                           budget=R_BUDGET, verify=True)
    d = exp.to_dict()
    d["budget"]["backend"] = "xla"
    assert d == ref.to_dict() and d["verify"]
    flt = t_faults.sample_faults(spec.build(), n_dead_links=1, seed=1)
    # Runtime faults are ported too.
    assert t_exp.Experiment(topology=spec, budget=T_BUDGET,
                            faults=flt).faults == flt
    cfg = exp.sim_config()
    assert (t_sweep.sweep(spec.build(), [cfg], verify=True)
            == t_sweep.sweep(spec.build(), [cfg]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_exp.Experiment(topology=spec, verify=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_sweep.sweep(spec.build(), [], verify=True)


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_power_area_analytic_equal(family):
    for n in SIZES:
        rt, tt = r_topo.build(family, n), t_topo.build(family, n)
        for act in (0.0, 0.37, 1.0):
            assert (dataclasses.asdict(r_power.power(rt, act))
                    == dataclasses.asdict(t_power.power(tt, act)))
        assert (dataclasses.asdict(r_area.area(rt))
                == dataclasses.asdict(t_area.area(tt)))
        assert (r_power.activity_from_sim(123.4, n)
                == t_power.activity_from_sim(123.4, n))
        assert (r_power.relative_extra_power(n)
                == t_power.relative_extra_power(n))
        for name in ("ring_mesh_diameter", "flat_mesh_diameter",
                     "ring_mesh_bisection", "flat_mesh_bisection"):
            assert (getattr(r_analytic, name)(n)
                    == getattr(t_analytic, name)(n))
    assert r_area.table3() == t_area.table3()
