"""The trace's records form (``trace.TraceRecords``): a phase in which a
source sends several ordered ``(dst, flits)`` records, held as arrays; its
validation, its tables, its adapter, and the plain twin's record walk, flit
by flit (the kernel's is held to the twin on the card in
``tests/test_torch_kernels_hopper.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core import sim, traffic
from repro_torch.core.spec import TopologySpec
from repro_torch.kernels import noc_step
from repro_torch.trace import Trace, TraceRecords, TraceSpec


def records(**kw):
    base = dict(n_pes=16, n_phases=2, phase=[1, 0, 0, 0, 1],
                src=[3, 2, 0, 2, 3], dst=[4, 5, 1, 7, 0],
                flits=[2, 1, 3, 2, 1])
    base.update(kw)
    return TraceRecords(**{k: np.asarray(v) if isinstance(v, list) else v
                           for k, v in base.items()})


def test_the_table_is_sorted_stably_by_phase_and_source():
    r = records()
    assert r.phase.tolist() == [0, 0, 0, 1, 1]
    assert r.src.tolist() == [0, 2, 2, 3, 3]
    # each source's records keep their stored order
    assert r.dst.tolist() == [1, 5, 7, 4, 0]
    assert r.phase.dtype == np.int32 and r.n_records == 5
    assert r.max_records_per_source() == 2


def test_the_tables_of_the_record_walk():
    r = records()
    start, dst, end = r.records()
    assert start.shape == (2, 16) and start.dtype == np.int32
    assert (start[0, 0], start[0, 2], start[1, 3]) == (0, 1, 3)
    # running ends restart at each source's first record of a phase
    assert end.tolist() == [3, 1, 3, 2, 3] and dst.tolist() == [1, 5, 7, 4, 0]
    first, totals = r.arrays()
    assert (first[0, 0], first[0, 2], first[1, 3]) == (1, 5, 4)
    assert totals[0].tolist()[:4] == [3, 0, 3, 0]
    assert totals[1, 3] == 3 and totals.sum() == 9


@pytest.mark.parametrize("change,match", [
    (dict(dst=[4, 5, 1, 7, 3]), "targets itself"),
    (dict(flits=[2, 1, 0, 2, 1]), "flits > 0"),
    (dict(dst=[4, 5, 16, 7, 0]), "out of range"),
    (dict(phase=[0, 0, 0, 0, 2]), "out of range"),
    (dict(phase=[0, 0, 0, 0, 0]), "phase 1 is empty"),
    (dict(src=[3, 2, 0]), "one length"),
])
def test_a_bad_table_is_refused(change, match):
    with pytest.raises(ValueError, match=match):
        records(**change)


def test_the_adapter_gives_the_tables_only_where_a_source_sends_two():
    multi = Trace(trace=records())
    assert multi.n_trace_phases == 2
    assert [a.tolist() for a in multi.trace_records(16)] == [
        a.tolist() for a in records().records()]
    one = Trace(trace=records(phase=[1, 0, 0, 0, 1], src=[3, 2, 0, 1, 4]))
    assert one.trace_records(16) is None
    spec = TraceSpec(n_pes=16, phases=(((0, 1, 2),),))
    assert Trace(trace=spec).trace_records(16) is None
    assert traffic.resolve("uniform").trace_records(16) is None
    with pytest.raises(ValueError, match="extracted for 16 PEs"):
        multi.trace_records(64)
    back = traffic.TrafficSpec.from_json(multi.to_json())
    assert isinstance(back.trace, TraceRecords)
    assert [a.tolist() for a in back.trace.records()] == [
        a.tolist() for a in records().records()]
    with pytest.raises(ValueError, match="TraceRecords"):
        TraceSpec(n_pes=16, phases=(((0, 1, 2), (0, 3, 1)),))


def injected(trace, cycles: int, pe: int) -> list:
    """``(cycle, dst)`` of each flit ``pe`` injected, from the twin's state
    after each cycle: the packed word at its inject queue's tail."""
    topo = TopologySpec("ring_mesh", 16).build()
    geom = sim.build_geometry(topo, "cpu")
    cfg = sim.SimConfig(cycles=cycles, warmup=0, inj_rate=1.0,
                        pattern=Trace(trace=trace), backend="torch",
                        device="cpu")
    inj, dst, tabs, _, _ = sim.batch_operands(
        [sim.make_point(cfg, 16, topo)], 16, cycles, "cpu")
    state = noc_step.initial_state(
        1, geom.n_links, geom.depth, "cpu", n_pes=16, n_phases=2,
        rec_start=tabs[3] if len(tabs) > 3 else None)
    row = int(geom.pe_src_link[pe])
    out = []
    for c in range(cycles):
        state, _ = noc_step.cycle_step(
            geom, state, c, inj[:, c], dst[:, c], warmup=0,
            starvation_limit=8, arb_iters=sim.ARB_ITERS, trace=tabs)
        n = int(state[1][0, row])
        word = int(state[0][0, row, n - 1]) if n else 0
        if n and word >> 11 == c:
            out.append((c, (word & 2047) - 1))
    return out, state


def test_the_twin_walks_a_source_s_records_without_a_gap():
    """PE 0 sends 3 flits to PE 1 in phase 0, then (phase 1, after the
    barrier) 2 to PE 9 and 1 to PE 6, back to back; PE 5's one record a
    phase rides along."""
    trace = TraceRecords(
        n_pes=16, n_phases=2, phase=np.array([0, 1, 1, 0, 1]),
        src=np.array([0, 0, 0, 5, 5]), dst=np.array([1, 9, 6, 2, 3]),
        flits=np.array([3, 2, 1, 1, 1]))
    got, state = injected(trace, 60, 0)
    assert [d for _, d in got] == [1, 1, 1, 9, 9, 6]
    cycles = [c for c, _ in got]
    assert cycles[:3] == [0, 1, 2] and cycles[3:] == [cycles[3] + k
                                                      for k in range(3)]
    done = state[8][0].tolist()
    assert done[0] < cycles[3] and done[1] > cycles[5]
    assert state[6][0].tolist() == [0] * 16      # sent restarts
    assert int(state[3][0, noc_step.DELIVERED]) == 8


def test_a_batch_mixes_the_two_forms():
    """A records trace and a one-record trace of as many phases batch into
    one run (the one-record point walks its one record a source), each as
    it runs alone."""
    topo = TopologySpec("ring_mesh", 16).build()
    multi = Trace(trace=records())
    one = Trace(trace=TraceSpec(n_pes=16, phases=(((0, 1, 2), (4, 9, 3)),
                                                  ((2, 8, 1),))))
    cfgs = [sim.SimConfig(cycles=80, warmup=0, inj_rate=1.0, pattern=p,
                          seed=s, backend="torch", device="cpu")
            for p, s in ((multi, 1), (one, 2))]
    both, _ = sim.run_batch(topo, cfgs)
    alone = [sim.simulate(topo, c) for c in cfgs]
    assert both == alone
    assert [r.delivered for r in both] == [9, 6]
    assert all(min(r.phase_done) >= 0 for r in both)


def test_the_largest_expert_counter_keeps_a_running_maximum():
    """``moe.expert_tokens_max`` is a maximum over the calls since the last
    drain, though counters sum; the other counters sum as counters do."""
    from repro_torch import telemetry
    from repro_torch.trace import moe
    model = dict(hidden_size=64, n_routed_experts=64, num_experts_per_tok=8,
                 n_group=8, topk_group=4, routed_scaling_factor=2.5,
                 norm_topk_prob=True)
    telemetry.drain()
    most = []
    for seed in (1, 2, 3):
        _, summary = moe.moe_exchange_trace(
            model, 64, 2, dispatch_bytes=7392, combine_bytes=14336,
            router_seed=seed, token_seed=seed + 10, device="cpu",
            scale=231.0)
        most.append(max(summary["expert_tokens"]))
        assert telemetry.counter("moe.expert_tokens_max") == max(most)
    assert len(set(most)) > 1
    assert telemetry.drain()["counters"]["moe.tokens"] == 3 * 64 * 2
