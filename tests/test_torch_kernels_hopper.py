"""The port's Hopper kernels: what the CPU can check, and their CUDA runs.

On the CPU: ``noc_step.cluster_plan`` (the cluster size and per-CTA shared
memory of the NoC kernel) against a layout computed by hand, its choice
on the main path's geometries and its refusals; the share of fan-in reads
that cross CTAs; and the kernel's refusal of geometries its narrowed rows
would not hold exactly.

On the card (``cuda``-marked, skipped here): the bfloat16 attention
kernel on the tensor cores against its plain version at every head width,
causal, windowed, GQA, with queries at the kv tail and on a query tile
that the sequence fills only in part; and every ``noc_step`` mode split
over clusters of more than one CTA, which the main path picks only at
1024 PEs, against the twin.  This file imports no jax, so on the card it
runs without the suite's conftest::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_hopper.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import sim
from repro_torch.core.spec import TopologySpec
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import noc_step as t_noc

torch.set_num_threads(1)


def _geometry(family, n_pes, depth=8, device="cpu"):
    topo = TopologySpec(family, n_pes, src_queue_depth=depth).build()
    return topo, sim.build_geometry(topo, device)


def _plan(geom, **kw):
    return t_noc.plan_for(geom, **kw)


# ---------------------------------------------------------------------------
# cluster_plan
# ---------------------------------------------------------------------------
def test_cluster_plan_matches_a_hand_computed_layout():
    # ring_mesh_256 at src_queue_depth 8: 1 761 queue rows, 1 201 output
    # channels, one CTA.  Each array is rounded up to 16 bytes.
    int32 = (1761 * 8 * 4          # q_pack                   56 352
             + 14_096              # head, two slots      2 x 1 761 * 4
             + 3 * 7056            # score, src_of, score_nc  1 761 * 4
             + 14_416              # best, three slots    3 x 1 201 * 4
             + 84 * 4)             # control block
    int16 = 10 * 3536              # nxt, nphys, wait, phys, prio, inj_pe,
    #                                the active list, nphys_nc, dst_v, orig
    bytes8 = 6 * 1776 + 3536       # q_len, cap, stat, room_nc, q_head,
    #                                inj_v; flags, two slots
    assert int32 + int16 + bytes8 == 155_920
    assert t_noc.cluster_plan(1761, 1201, 8, 256, 0, 0) == (1, 155_920)
    # trace mode adds the per-PE sent counts and two words per phase, fault
    # mode four words per entry, each array rounded up to 16 bytes
    assert t_noc.cluster_plan(1761, 1201, 8, 256, 3, 5) == (
        1, 155_920 + 256 * 4 + 2 * 32 + 4 * 16)
    # a cluster splits rows and channels evenly, rounding up: ring_mesh_1024
    # needs three CTAs of 2 369 rows and 1 611 channels
    assert t_noc.cluster_plan(7105, 4833, 8, 1024, 0, 0) == (3, 209_488)
    assert t_noc.shared_bytes(2369, 1611, 8, 1024, 0, 0) == (
        2369 * 32 + 18_960 + 3 * 9488 + 19_344 + 336 + 10 * 4752
        + 6 * 2384 + 4752) == 209_488


@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_cluster_plan_on_the_main_path_geometries(family):
    for n_pes in (64, 256):
        _, geom = _geometry(family, n_pes)
        c, nbytes = _plan(geom)
        assert c == 1 and nbytes <= t_noc.SHARED_LIMIT_BYTES, (n_pes, nbytes)
    _, geom = _geometry(family, 1024)
    lp1, np1 = geom.route.shape[0], geom.cand.shape[0]
    for faults, phases in ((0, 0), (16, 0), (0, 20)):
        c, nbytes = t_noc.cluster_plan(lp1, np1, geom.depth, 1024, faults,
                                       phases)
        assert 1 < c <= t_noc.MAX_CLUSTER
        assert nbytes <= t_noc.SHARED_LIMIT_BYTES
        smaller = t_noc.shared_bytes(-(-lp1 // (c - 1)), -(-np1 // (c - 1)),
                                     geom.depth, 1024, faults, phases)
        assert smaller > t_noc.SHARED_LIMIT_BYTES, (c, smaller)


def test_cluster_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="cluster size 8"):
        t_noc.cluster_plan(40_000, 30_000, 8, 1024, 0, 0)
    with pytest.raises(ValueError, match="cluster size 1"):
        t_noc.cluster_plan(7105, 4833, 8, 1024, 0, 0, cluster=1)
    with pytest.raises(ValueError, match="1..8"):
        t_noc.cluster_plan(433, 297, 8, 64, 0, 0, cluster=9)
    assert t_noc.cluster_plan(433, 297, 8, 64, 0, 0, cluster=3)[0] == 3


def test_locality_order_keeps_a_node_together():
    """The kernel's row order at C > 1: permutations with the dummy row and
    channel last, under which a row's target channel sits in its own CTA
    and far fewer route hops cross CTAs than in the geometry's order."""
    _, geom = _geometry("flat_mesh", 256)
    rows, chans = t_noc.locality_order(geom)
    lp1, np1 = geom.route.shape[0], geom.cand.shape[0]
    assert sorted(rows.tolist()) == list(range(lp1)) and rows[-1] == lp1 - 1
    assert sorted(chans.tolist()) == list(range(np1)) and chans[-1] == np1 - 1
    assert t_noc.remote_share(geom, 1) == {"channel": 0.0, "next_row": 0.0}
    share = t_noc.remote_share(geom, 4)
    assert share["channel"] < 0.01 and 0.0 < share["next_row"] < 0.2
    lay = t_noc.layout(geom, 4)
    assert t_noc.layout(geom, 4) is lay  # built once per geometry tables
    assert torch.equal(lay.orig.long(), lay.rows)
    assert torch.equal(lay.rows[lay.row_at], torch.arange(lp1))
    assert torch.equal(torch.from_numpy(chans)[lay.phys.long()],
                       geom.phys[lay.rows].long())
    assert torch.equal(lay.cap, geom.cap[lay.rows])
    one = t_noc.layout(geom, 1)
    assert one.rows is None and one.cap is geom.cap


def test_contending_rows_are_the_queues_of_the_candidate_table():
    from repro_torch.faults import sample_faults

    healthy = TopologySpec("flat_mesh", 64)
    repaired = dataclasses.replace(healthy, faults=sample_faults(
        healthy.build(), n_dead_links=3, seed=6)).build()
    counts = []
    for topo in (healthy.build(), repaired):
        geom = sim.build_geometry(topo, "cpu")
        got = t_noc.layout(geom, 1).contends
        lp1 = geom.route.shape[0]
        want = torch.zeros(lp1, dtype=torch.uint8)
        for q in geom.cand.reshape(-1).tolist():
            if q != lp1 - 1:
                want[q] = 1
        assert torch.equal(got, want)
        counts.append(int(got.sum()))
    # a repaired fabric's dead queues are no one's candidates
    assert counts[1] < counts[0]


def test_run_fused_refuses_what_the_narrow_rows_cannot_hold():
    _, geom = _geometry("ring_mesh", 16)
    with pytest.raises(ValueError, match="starvation_limit"):
        t_noc._check_narrow(geom, 70_000)
    t_noc._check_narrow(geom, 8)  # the simulator's own geometry fits
    cap = geom.cap.clone()
    sink = int(torch.nonzero(geom.is_sink)[0])
    cap[sink] = 1 << 30  # an unbounded sink: still fine
    t_noc._check_narrow(dataclasses.replace(geom, cap=cap), 8)
    inject = int(geom.pe_src_link[0])
    cap[inject] = 300  # an inject queue past a byte: refused
    with pytest.raises(ValueError, match="unbounded queue"):
        t_noc._check_narrow(dataclasses.replace(geom, cap=cap), 8)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
FLASH_BF16_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window)
    *[(2, 4, 2, 256, 256, d, True, None) for d in t_flash.HEAD_DIMS],
    *[(1, 4, 4, 384, 384, d, False, None) for d in (64, 80)],
    (1, 8, 2, 512, 512, 64, True, 100),        # window, GQA
    (1, 4, 1, 256, 1024, 80, True, 384),       # queries at the kv tail
    (2, 4, 2, 1, 256, 128, True, None),        # decode: one query
    (1, 3, 1, 96, 96, 32, True, None),         # a part-filled query tile
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES, ids=str)
def test_flash_bf16_tensor_cores_match_plain(card, case):
    b, hq, hkv, sq, skv, d, causal, window = case
    rng = np.random.default_rng(sq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card, torch.bfloat16)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    t_flash.reset_launches()
    got = t_flash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert t_flash.launches == 1
    want = t_flash.plain(q, k, v, causal=causal, window=window)
    if case == FLASH_BF16_CASES[0]:  # 16-byte chunks need aligned rows
        shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
        with pytest.raises(ValueError, match="aligned"):
            t_flash.flash_attention(shifted[1:].view(q.shape), k, v)
    # 2e-2: outputs rounded to bfloat16 on both sides, and the kernel's
    # probabilities rounded to bfloat16 as its P V operand.
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _operands(topo, geom, cfgs):
    c0 = cfgs[0]
    points = [sim.make_point(c, topo.n_pes, topo) for c in cfgs]
    inj, dst, trace, faults, fault_u = sim.batch_operands(
        points, topo.n_pes, c0.cycles, geom.route.device)
    return inj, dst, dict(warmup=c0.warmup,
                          starvation_limit=c0.starvation_limit,
                          arb_iters=sim.ARB_ITERS, trace=trace,
                          faults=faults, fault_u=fault_u, diagnostics=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["statistical", "faults", "trace",
                                  "trace+faults"])
def test_noc_step_on_clusters_matches_twin(card, mode):
    from repro_torch import trace as tr
    from repro_torch.faults import sample_faults

    topo, geom = _geometry("ring_mesh", 64, device=card)
    faults = sample_faults(topo, n_dead_links=3, seed=2)
    schedule = next(iter(tr.traces_for_schedules(64).values()))
    kw = dict(inj_rate=0.9, seed=5, cycles=300, warmup=40)
    if "trace" in mode:
        kw.update(inj_rate=1.0, warmup=0, pattern=schedule)
    if "faults" in mode:
        kw.update(faults=faults)
    cfgs = [sim.SimConfig(**kw), sim.SimConfig(**{**kw, "seed": 6})]
    inj, dst, opts = _operands(topo, geom, cfgs)
    want = t_noc.run_plain(geom, inj, dst, **opts)
    for c in (2, 3, 5, 8):
        got = t_noc.run_fused(geom, inj, dst, cluster_size=c, **opts)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y), (mode, c)


@pytest.mark.cuda
def test_noc_step_at_1024_pes_matches_twin(card):
    topo, geom = _geometry("flat_mesh", 1024, device=card)
    assert _plan(geom)[0] > 1
    cfgs = [sim.SimConfig(inj_rate=0.625, seed=1, cycles=60, warmup=10,
                          **sim.PAPER_LOCALITY)]
    inj, dst, opts = _operands(topo, geom, cfgs)
    got = t_noc.run_fused(geom, inj, dst, **opts)
    want = t_noc.run_plain(geom, inj, dst, **opts)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
