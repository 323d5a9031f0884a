"""A whole run of the harness, its look for a card skipped, with the timed
path broken underneath: ``correct`` has to come out false for each fault
the cells can have.  (A sound run beside them comes out true.)  One card
a cell, so no exchange between chips can be left out."""
import time

import pytest
import torch

from noc_bench import generator, harness
from noc_bench.reference import noc


def small(family: str) -> dict:
    cfg = dict(generator.load_json("configs", f"{family}-1024"))
    cfg["fabric"] = dict(cfg["fabric"], n_pes=64)
    cfg["cycles"], cfg["warmup"] = 120, 30
    return cfg


GRID = dict(generator.load_json("traffic", "paper_grid"),
            patterns=["uniform", "transpose"], inj_rates=[0.25, 1.0])
REPAIR = dict(generator.load_json("traffic", "resilience"),
              budget={"cycles": 150, "warmup": 0}, inj_rates=[0.1])
# The replay at 64 PEs: each schedule's first phases within 150 cycles.
REPLAY = dict(generator.load_json("traffic", "collectives"),
              budget={"cycles": 150, "warmup": 0})
CELLS = {"grid": ("ring_mesh-1024.paper_grid", "ring_mesh", GRID),
         "repair": ("ring_mesh-1024.resilience", "ring_mesh", REPAIR),
         "replay": ("ring_mesh-1024.collectives", "ring_mesh", REPLAY)}


def run_cell(which: str) -> dict:
    name, family, mix = CELLS[which]
    return harness.run(name, 4_000_000_007, 0.3, False,
                       t0=time.perf_counter(), device="cpu",
                       backend="torch", config=small(family), mix=mix)


def stepped_clock(monkeypatch, step: float = 0.25):
    """A window clock that advances ``step`` seconds at each request the
    generator draws, and not otherwise: a traced window then passes
    through its modes at the same requests however fast the host runs."""
    now = [0.0]
    draw = generator.Generator.request

    def request(self, i):
        now[0] += step
        return draw(self, i)
    monkeypatch.setattr(generator.Generator, "request", request)
    return lambda: now[0]


def break_kernel(monkeypatch, how: str) -> None:
    """Break the timed cycle loop (the plain twin, the CPU's backend)."""
    from repro_torch.kernels import noc_step
    plain = noc_step.run_plain

    def broken(geom, inj_s, dst_s, **kw):
        q_len, m_scal, m_kind, passes, ph_done = plain(geom, inj_s, dst_s,
                                                       **kw)
        if how == "state_unchanged":
            return (torch.zeros_like(q_len), torch.zeros_like(m_scal),
                    torch.zeros_like(m_kind), passes, ph_done)
        if how == "half_batch":
            b = inj_s.shape[0]
            if b < 2:
                return q_len, m_scal, m_kind, passes, ph_done
            half = plain(geom, inj_s[: b // 2], dst_s[: b // 2], **dict(
                kw, faults=None if kw["faults"] is None else tuple(
                    t[: b // 2] for t in kw["faults"]),
                fault_u=None if kw["fault_u"] is None
                else kw["fault_u"][: b // 2]))
            idx = torch.arange(b) % (b // 2)
            return tuple(t[idx] if t.dim() else t for t in half)
        m_scal = m_scal.clone()
        m_scal[0, noc_step.DELIVERED] += 1
        return q_len, m_scal, m_kind, passes, ph_done

    monkeypatch.setattr(noc_step, "run_plain", broken)


@pytest.mark.parametrize("which", ["grid", "replay"])
def test_a_sound_run_is_correct(which):
    line = run_cell(which)
    assert line["correct"] and line["failed"] == 0, line["check"]
    assert line["requests_checked"] == 1


@pytest.mark.parametrize("which,how", [
    ("grid", "state_unchanged"), ("grid", "half_batch"),
    ("grid", "answer_altered"), ("replay", "state_unchanged"),
    ("replay", "answer_altered")])
def test_a_broken_cycle_loop_is_not_correct(monkeypatch, which, how):
    """A replay is a batch of one point, so it has no half to leave out."""
    break_kernel(monkeypatch, how)
    line = run_cell(which)
    assert not line["correct"]
    assert line["check"]["sim_values_differing"]["value"] > 0


def test_a_corrupted_phase_table_is_not_correct(monkeypatch):
    """One flit more for the first source of the first phase, in the
    trace the program builds in the timed path."""
    from repro_torch.trace import spec
    arrays = spec.TraceSpec.arrays

    def corrupted(self):
        dst, flits = arrays(self)
        flits = flits.copy()
        flits[0, 0] += 1
        return dst, flits
    monkeypatch.setattr(spec.TraceSpec, "arrays", corrupted)
    line = run_cell("replay")
    assert not line["correct"]
    assert line["check"]["sim_values_differing"]["value"] > 0


def test_a_repair_that_does_not_reroute_is_not_correct(monkeypatch):
    from repro_torch.core import topology
    monkeypatch.setattr(topology, "reroute_avoiding",
                        lambda topo, dead: (topo.route_table,
                                            noc.np.ones((topo.n_pes,) * 2,
                                                        bool)))
    line = run_cell("repair")
    assert not line["correct"]


def test_an_altered_certificate_is_not_correct(monkeypatch):
    from repro_torch.analysis import fabric
    check = fabric._check_liveness

    def altered(*a, **k):
        res = check(*a, **k)
        return type(res)(res.name, not res.ok, res.waived, res.data,
                         res.witness)
    monkeypatch.setattr(fabric, "_check_liveness", altered)
    line = run_cell("repair")
    assert not line["correct"]
    assert line["check"]["certificate_values_differing"]["value"] > 0


def test_a_request_that_raises_is_not_correct(monkeypatch):
    from repro_torch.kernels import noc_step
    plain, calls = noc_step.run_plain, []

    def fails_once(*a, **k):
        calls.append(1)
        if len(calls) == 2:   # the first request after the warm-up
            raise RuntimeError("launch failed")
        return plain(*a, **k)
    monkeypatch.setattr(noc_step, "run_plain", fails_once)
    line = run_cell("grid")
    assert line["failed"] == 1 and line["attempted"] >= 2
    assert not line["correct"]
    assert line["check"]["requests_failed"]["value"] == 1


def test_a_traced_run_goes_quiet_then_spans_then_profiled(monkeypatch,
                                                          capsys):
    """The window's first third runs unsynchronised, then under the
    synchronising spans, and its last ``SLICE_S`` under the profiler; the
    span metrics read the middle, and the run stays correct."""
    monkeypatch.setattr(harness, "SLICE_S", 0.6)
    name, family, mix = CELLS["grid"]
    line = harness.run(name, 4_000_000_009, 2.0, True,
                       t0=time.perf_counter(), device="cpu",
                       backend="torch", config=small(family), mix=mix,
                       clock=stepped_clock(monkeypatch))
    assert line["correct"], line["check"]
    err = capsys.readouterr().err
    for mode in ("quiet", "profiled", "spans"):
        assert f"{mode} requests: " in err, err
    assert line["metrics"]["streams.ms_per_point"]["value"] > 0
    assert "job_mfu" not in line["metrics"]      # no launch on the CPU
