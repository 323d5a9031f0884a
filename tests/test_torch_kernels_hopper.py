"""The port's Hopper kernels: what the CPU can check, and their CUDA runs.

On the CPU: ``noc_step.cluster_plan`` (the cluster size and per-CTA shared
memory of the NoC kernel) against a layout computed by hand, its choice
on the main path's geometries and its refusals; the share of fan-in reads
that cross CTAs; the kernel's view of a geometry (``layout``: built once
per fabric, order and route, checked afresh for a replaced table, freed
with its topology); the kernel's refusal of geometries its narrowed rows
would not hold exactly; ``ssd_scan.plan`` (blocks per (batch, head),
threads and shared memory of the SSD kernels) against a layout computed
by hand, its choice at Zamba2's shape and at a large batch, mamba2-1.3b's
d_state 128 fitting, and its refusals; and the bfloat16 SSD kernel's
arithmetic emulated in plain PyTorch, which shows why it splits the
operands it computes into bf16 hi + lo halves.

On the card (``cuda``-marked, skipped here): the bfloat16 attention
kernel on the tensor cores against its plain version at every head width,
causal, windowed, GQA, with queries at the kv tail and on a query tile
that the sequence fills only in part; the bfloat16 SSD kernel on the
tensor cores against its plain version over the CPU tests' matrix, on
chunks and widths that do not tile by 16 (through ``ops.ssd`` too), in
the fast- and slow-decay regimes, at d_state 128 and at every split of
P the planner allows; and every ``noc_step`` mode split over clusters of
more than one CTA, which the main path picks only at 1024 PEs, against
the twin, the trace mode's record walk (a MoE layer's exchange) at 64 and
1024 PEs, and the mined collective traces through it; and the decoder-only model zoo at smoke size (dense, sliding
window, MoE, SSM) through its kernels against the plain route, with each
forward's launches counted.  This file imports no jax, so on the card it
runs without the suite's conftest::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_hopper.py
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import sim
from repro_torch.core.spec import TopologySpec
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import noc_step as t_noc
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ssd_scan as t_ssd

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
             + 88 * 4)             # control block
    int16 = 10 * 3536              # nxt, nphys, wait, phys, prio, inj_pe,
    #                                the active list, nphys_nc, dst_v, orig
    bytes8 = 6 * 1776 + 3536       # q_len, cap, stat, room_nc, q_head,
    #                                inj_v; flags, two slots
    assert int32 + int16 + bytes8 == 155_936
    assert t_noc.cluster_plan(1761, 1201, 8, 256, 0, 0) == (1, 155_936)
    # trace mode adds the per-PE sent counts and two words per phase, fault
    # mode four words per entry, each array rounded up to 16 bytes
    assert t_noc.cluster_plan(1761, 1201, 8, 256, 3, 5) == (
        1, 155_936 + 256 * 4 + 2 * 32 + 4 * 16)
    # a cluster splits rows and channels evenly, rounding up: ring_mesh_1024
    # needs three CTAs of 2 369 rows and 1 611 channels
    assert t_noc.cluster_plan(7105, 4833, 8, 1024, 0, 0) == (3, 209_504)
    assert t_noc.shared_bytes(2369, 1611, 8, 1024, 0, 0) == (
        2369 * 32 + 18_960 + 3 * 9488 + 19_344 + 352 + 10 * 4752
        + 6 * 2384 + 4752) == 209_504


def test_cluster_plan_counts_the_record_cursors():
    """Records form adds one int32 cursor a PE beside the sent counts; the
    paper's 1024-PE ring-mesh keeps its three CTAs in both forms."""
    assert t_noc.cluster_plan(1761, 1201, 8, 256, 0, 2, records=True) == (
        1, 155_936 + 256 * 4 + 256 * 4 + 2 * 16)
    assert t_noc.cluster_plan(7105, 4833, 8, 1024, 0, 20) == (3, 213_760)
    assert t_noc.cluster_plan(7105, 4833, 8, 1024, 0, 2,
                              records=True) == (3, 213_632 + 4096)


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
    # The route in the kernel's order: its rows, and the ids it holds
    # renumbered; -1 stays -1.
    row_at = np.argsort(rows)
    hop = geom.route.numpy().astype(np.int64)[rows]
    want = np.where(hop >= 0, row_at[np.maximum(hop, 0)], -1)
    assert lay.route.dtype == torch.int16 and (want == -1).any()
    assert np.array_equal(lay.route.numpy(), want)
    one = t_noc.layout(geom, 1)
    assert one.rows is None and one.cap is geom.cap
    assert one.route is geom.route


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
    """The geometry's refusals come from its view (``layout``), once per
    geometry; ``starvation_limit`` is the launch's own operand."""
    _, geom = _geometry("ring_mesh", 16)
    inj = torch.zeros((2, 5, 16), dtype=torch.bool)
    dst = torch.zeros((2, 5, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="starvation_limit"):
        t_noc._check_launch(geom, inj, dst, 70_000)
    t_noc._check_launch(geom, inj, dst, 8)
    t_noc.layout(geom, 1)  # the simulator's own geometry fits
    cap = geom.cap.clone()
    sink = int(torch.nonzero(geom.is_sink)[0])
    cap[sink] = 1 << 30  # an unbounded sink: still fine
    t_noc.layout(dataclasses.replace(geom, cap=cap), 1)
    inject = int(geom.pe_src_link[0])
    cap[inject] = 300  # an inject queue past a byte: refused
    with pytest.raises(ValueError, match="unbounded queue"):
        t_noc.layout(dataclasses.replace(geom, cap=cap), 1)
    with pytest.raises(ValueError, match="depth <= 254"):
        t_noc.layout(dataclasses.replace(geom, depth=300), 1)


def test_a_geometry_view_is_built_once_for_every_geometry_of_a_fabric():
    """``layout`` keeps its view in ``geom.kernel``: every geometry that
    ``build_geometry`` makes of a topology on a device is served the same
    objects; one carried from arrays has a dict of its own."""
    topo, geom = _geometry("flat_mesh", 64)
    for cluster in (1, 4):
        lay = t_noc.layout(geom, cluster)
        again = sim.build_geometry(topo, "cpu")
        assert again is not geom and again.kernel is geom.kernel
        assert t_noc.layout(again, cluster) is lay
        assert t_noc.layout(geom, cluster) is lay
    carried = sim.geometry_from_arrays(
        {k: getattr(geom, k).numpy() for k in sim.GEOMETRY_ARRAYS},
        depth=geom.depth, cap_total=geom.cap_total, device="cpu")
    assert carried.kernel == {} and carried.kernel is not geom.kernel
    assert torch.equal(t_noc.layout(carried, 4).route, lay.route)


@pytest.mark.parametrize("field,bad,match", [
    ("cap", lambda t: t - (1 << 30), "negative capacity"),
    ("prio", lambda t: t + 0x8000, "prio outside int16"),
    ("kind", lambda t: t[:-1].clone(), "'kind' must be"),
    ("cand", lambda t: t.to(torch.int64), "'cand' must be"),
])
def test_a_replaced_table_is_checked_not_served_the_view(field, bad, match):
    """``dataclasses.replace`` shares the view dict: a geometry holding
    another tensor gets a view built and checked afresh, so a bad table is
    refused; the first geometry keeps its view."""
    _, geom = _geometry("ring_mesh", 64)
    lay = t_noc.layout(geom, 3)
    worse = dataclasses.replace(geom, **{field: bad(getattr(geom, field))})
    assert worse.kernel is geom.kernel
    with pytest.raises(ValueError, match=match):
        t_noc.layout(worse, 3)
    assert t_noc.layout(geom, 3) is lay


def test_a_new_route_reuses_the_static_view(monkeypatch):
    """A route reassignment (a morph) keeps the static part of the view,
    with no second ``locality_order``, and rebuilds the kernel-order route
    once; the view holds one route an order."""
    topo = TopologySpec("flat_mesh", 64).build_fresh()
    geom = sim.build_geometry(topo, "cpu")
    lay = t_noc.layout(geom, 4)
    calls = []
    order = t_noc.locality_order
    monkeypatch.setattr(t_noc, "locality_order",
                        lambda g: calls.append(g) or order(g))
    moved = topo.route_table.copy()
    moved[int(topo.pe_src_link[0]), 5] = -1
    topo.route_table = moved
    morphed = sim.build_geometry(topo, "cpu")
    new = t_noc.layout(morphed, 4)
    assert new.kind is lay.kind and new.rows is lay.rows
    assert new.route is not lay.route and not torch.equal(new.route,
                                                          lay.route)
    assert t_noc.layout(morphed, 4) is new and calls == []
    hop = morphed.route[new.rows].long()
    assert torch.equal(new.route.long(), torch.where(
        hop >= 0, new.row_at[hop.clamp(min=0)], -1))
    assert sorted(map(str, geom.kernel)) == ["(True, 'route')", "True"]


def test_the_view_is_freed_with_its_topology():
    """No module keeps a view: it lives in the topology's geometry entry
    and goes with the topology."""
    assert not hasattr(t_noc, "_LAYOUTS")
    topo = TopologySpec("flat_mesh", 64).build_fresh()
    geom = sim.build_geometry(topo, "cpu")
    lay = t_noc.layout(geom, 4)
    refs = [weakref.ref(t) for t in (lay.route, lay.kind, lay.contends,
                                     geom.cand, geom.route)]
    del topo, geom, lay
    gc.collect()
    assert [r() for r in refs] == [None] * len(refs)


# ---------------------------------------------------------------------------
# ssd_scan.plan and the bfloat16 kernel's arithmetic
# ---------------------------------------------------------------------------
BF16, F32 = torch.bfloat16, torch.float32


def test_ssd_plan_matches_a_hand_computed_layout():
    # Zamba2: chunk 128, N = P = 64.  bf16 rows padded by 8 elements:
    # x [2][128][72], b and c [2][128][72] each, the state's hi and lo
    # halves [64][72] each; float32 dt [2][128], cum/exp/w [3][128].
    one = (2 * 128 * 72 * 2 + 2 * 2 * 128 * 72 * 2 + 2 * 64 * 72 * 2
           + 2 * 128 * 4 + 3 * 128 * 4)
    assert one == 131_584
    assert t_ssd.shared_bytes(128, 64, 64, 1, BF16) == one
    # k = 2: 32 columns a block, x and the state rows 40 wide
    assert t_ssd.shared_bytes(128, 64, 64, 2, BF16) == one - (
        2 * 128 * 32 * 2 + 2 * 64 * 32 * 2) == 107_008
    # a chunk of 40 pads to 48 rows; N 24 pads to 32 state rows; 8 columns
    # of a block pad to 16
    assert t_ssd.shared_bytes(40, 24, 16, 2, BF16) == (
        2 * 48 * 24 * 2 + 2 * 2 * 48 * 40 * 2 + 2 * 32 * 24 * 2
        + 2 * 48 * 4 + 3 * 48 * 4) == 24_000
    # float32: the scalar kernel's float32 tiles, one block per (b, h)
    # where they fit; at k = 2 each block holds 32 columns of x and state
    assert t_ssd.shared_bytes(128, 64, 64, 1, F32) == 4 * (
        64 * 64 + 128 * 64 + 128 * 65 + 128 * 64 + 128 * 129 + 3 * 128)
    assert t_ssd.plan(128, 128, 64, 64, F32) == (
        1, t_ssd.SCALAR_THREADS, 182_784)
    assert t_ssd.shared_bytes(128, 64, 64, 2, F32) == 182_784 - 4 * (
        64 * 32 + 128 * 32)
    # splits the kernel does not take: columns not in slices of 8..64
    for k in (3, 16):
        assert t_ssd.shared_bytes(128, 64, 64, k, BF16) is None
    assert t_ssd.shared_bytes(128, 64, 128, 1, BF16) is None
    assert t_ssd.shared_bytes(128, 64, 64, 3, F32) is None
    assert t_ssd.splits(128, 64, 64, BF16) == [1, 2, 4, 8]
    # P and N that are not multiples of 8 are padded: P 20 -> 24 (k 1, 3)
    assert t_ssd.splits(32, 12, 20, BF16) == [1, 3]


def test_ssd_plan_on_zamba2_and_a_large_batch():
    # Zamba2 scoring: batch 2 x 64 heads, chunk 128, N = P = 64
    # (128 pairs, one block each, cover 97 % of the 132 SMs)
    assert t_ssd.plan(128, 128, 64, 64, BF16) == (
        1, t_ssd.TC_THREADS, 131_584)
    # a large batch: one block per pair; a single sequence of mamba2-1.3b
    # (64 heads): two; 8 pairs: the largest split
    assert t_ssd.plan(32 * 64, 128, 64, 64, BF16)[0] == 1
    assert t_ssd.plan(64, 128, 128, 64, BF16)[0] == 2
    assert t_ssd.plan(8, 128, 128, 64, BF16)[0] == 8
    assert t_ssd.plan(128, 128, 64, 64, BF16, split=8) == (
        8, t_ssd.TC_THREADS, t_ssd.shared_bytes(128, 64, 64, 8, BF16))


def test_ssd_plan_fits_d_state_128():
    # mamba2-1.3b (src/repro/configs/mamba2_1_3b.py): N 128, P 64, chunk
    # 128.  One float32 block would take 4 * (8 192 + 8 192 + 16 512 +
    # 16 384 + 16 512 + 384) bytes, past the limit; two blocks per (b, h)
    # halve the state and x and fit with 512 bytes to spare.
    k, _, nbytes = t_ssd.plan(64, 128, 128, 64, BF16)
    assert nbytes <= t_ssd.SHARED_LIMIT_BYTES
    assert t_ssd.shared_bytes(128, 128, 64, 1, BF16) == 215_552
    assert t_ssd.splits(128, 128, 64, BF16) == [1, 2, 4, 8]
    assert t_ssd.shared_bytes(128, 128, 64, 1, F32) == 264_704 > \
        t_ssd.SHARED_LIMIT_BYTES
    assert t_ssd.splits(128, 128, 64, F32) == [2, 4, 8, 16, 32, 64]
    assert t_ssd.plan(128, 128, 128, 64, F32) == (
        2, t_ssd.SCALAR_THREADS, 231_936)
    assert t_ssd.SHARED_LIMIT_BYTES - 231_936 == 512


def test_ssd_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="every split"):
        t_ssd.plan(128, 512, 256, 64, BF16)
    with pytest.raises(ValueError, match="split 3"):
        t_ssd.plan(128, 128, 64, 64, BF16, split=3)
    with pytest.raises(ValueError, match="split 3"):
        t_ssd.plan(128, 128, 64, 64, F32, split=3)
    # the float32 score tile alone passes the limit at chunk 256
    with pytest.raises(ValueError, match="every split"):
        t_ssd.plan(128, 256, 64, 64, F32)
    # N past the kernel's 256 state rows fits no split
    assert t_ssd.splits(16, 264, 16, BF16) == []


def _ssd_inputs(case, seed=0):
    """x, b, c standard normal, dt = softplus(N(0,1) - 1) and a =
    -exp(N(0,1)/2) in float32, as chip_smoke.py makes them."""
    b, h, g, s, p, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, s)) - 1.0))
    a = -np.exp(rng.standard_normal(h) * 0.5)
    bb = rng.standard_normal((b, g, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, g, s, n)).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(dt.astype(np.float32)),
            torch.from_numpy(a.astype(np.float32)), torch.from_numpy(bb),
            torch.from_numpy(cc))


def _truncated(v):
    """v with the lower 16 bits of each float32 cleared: a bf16 value."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def _tc_arithmetic(x, dt, a, b, c, chunk, split):
    """The bfloat16 kernel's arithmetic in plain PyTorch: exact products
    of bf16 operands summed in float32, with the operands the kernel
    computes (M, the carried state, b * w) rounded to bf16 once
    (``split`` False) or as the kernel takes them (True): hi + lo bf16
    halves, each the upper 16 bits of a float32."""
    def operand(v):
        if not split:
            return v.to(BF16).float()
        hi = _truncated(v)
        return hi + _truncated(v - hi)
    bsz, h, s, p = x.shape
    rep = h // b.shape[1]
    bb = b.repeat_interleave(rep, 1).float()
    cc = c.repeat_interleave(rep, 1).float()
    xf, dtf = x.float(), dt.float()
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    state = torch.zeros(bsz, h, b.shape[3], p)
    ys = []
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        cum = torch.cumsum(dtf[:, :, sl] * a[None, :, None], -1)
        xc, dc, bc, ccx = xf[:, :, sl], dtf[:, :, sl], bb[:, :, sl], \
            cc[:, :, sl]
        m = torch.where(tri, (ccx @ bc.transpose(-1, -2))
                        * torch.exp(cum[..., :, None] - cum[..., None, :])
                        * dc[..., None, :], 0.0)
        y = torch.exp(cum)[..., None] * (ccx @ operand(state))
        ys.append(y + operand(m) @ xc)
        w = torch.exp(cum[..., -1:] - cum) * dc
        state = torch.exp(cum[..., -1])[..., None, None] * state + \
            operand(bc * w[..., None]).transpose(-1, -2) @ xc
    return torch.cat(ys, 2).to(BF16)


@pytest.mark.parametrize("split", [True, False], ids=["hi+lo", "one bf16"])
def test_ssd_bf16_arithmetic_needs_split_operands(split):
    """At Zamba2's widths (N = P = 64, chunk 128) over 8 chunks, the
    kernel's scheme holds the 2e-2 tolerance against the plain version
    with room to spare, while one bf16 rounding of the computed operands
    does not: outputs are sums of terms far larger than themselves."""
    case = (1, 4, 1, 1024, 64, 64, 128)
    x, dt, a, b, c = _ssd_inputs(case, seed=8)
    x, b, c = x.to(BF16), b.to(BF16), c.to(BF16)
    want = t_ssd.plain(x, dt, a, b, c, chunk=128).float()
    got = _tc_arithmetic(x, dt, a, b, c, 128, split).float()
    worst = float(((got - want).abs() / (2e-2 + 2e-2 * want.abs())).max())
    if split:
        assert worst < 0.5, worst
    else:
        assert worst > 1.5, worst


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
    (2, 4, 4, 45, 93, 64, False, None),        # cross: neither tiles
    (1, 4, 4, 1, 93, 64, False, None),         # one cross decode row
    (1, 2, 2, 150, 150, 64, False, None),      # an encoder past one tile
    (1, 4, 2, 130, 200, 128, True, None),      # ragged, at the kv tail
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


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 3])
def test_noc_step_counters(card, cluster):
    """The kernel's counters: off (telemetry off, a null clock pointer)
    the launch writes no clock and keeps no record; on, its outputs are
    the same, and each CTA's barrier-wait cycles lie between 0 and the
    cycles of its whole loop.  Through the simulator, the kernel's passes
    of a 64-PE point equal the twin's."""
    from repro_torch import telemetry

    topo, geom = _geometry("ring_mesh", 64, device=card)
    cfgs = [sim.SimConfig(inj_rate=0.9, seed=5, cycles=300, warmup=40)]
    inj, dst, opts = _operands(topo, geom, cfgs)
    telemetry.drain()
    off = t_noc.run_fused(geom, inj, dst, cluster_size=cluster, **opts)
    torch.cuda.synchronize()
    assert telemetry.drain()["kernels"] == []
    telemetry.enable()
    try:
        on = t_noc.run_fused(geom, inj, dst, cluster_size=cluster, **opts)
        torch.cuda.synchronize()
    finally:
        telemetry.disable()
    [rec] = telemetry.drain()["kernels"]
    for x, y in zip(on, off):
        assert torch.equal(x, y)
    assert rec["name"] == "noc_step.clock" and rec["cluster"] == cluster
    clock = np.array(rec["clock"])
    assert clock.shape == (1, cluster, 2)
    assert (clock[..., 0] > 0).all() and (clock[..., 0] < clock[..., 1]).all()

    passes = {}
    telemetry.enable()
    try:
        for backend in ("cuda", "torch"):
            sim.run_batch(topo, [dataclasses.replace(cfgs[0], backend=backend,
                                                     device="cuda")])
            passes[backend] = [k["passes"] for k in telemetry.drain()[
                "kernels"] if k["name"] == "noc_step.passes"]
    finally:
        telemetry.disable()
    assert passes["cuda"] == passes["torch"] and passes["cuda"][0][0] >= 300


def _exchange(card, n_pes, tokens_per_pe, cycles):
    """A MoE layer's exchange (records form: up to ~60 records a source a
    phase) on the ring-mesh of ``n_pes``, one expert a PE."""
    from repro_torch.trace import moe
    experts = 256 if n_pes == 1024 else n_pes
    model = dict(hidden_size=7168 if n_pes == 1024 else 256,
                 n_routed_experts=experts, num_experts_per_tok=8, n_group=8,
                 topk_group=4, routed_scaling_factor=2.5, norm_topk_prob=True)
    trace, _ = moe.moe_exchange_trace(
        model, n_pes, tokens_per_pe, dispatch_bytes=7392,
        combine_bytes=14336, router_seed=3, token_seed=9, device=card,
        scale=231.0)
    topo, geom = _geometry("ring_mesh", n_pes, device=card)
    cfgs = [sim.SimConfig(cycles=cycles, warmup=0, inj_rate=1.0,
                          pattern=trace, seed=4, device="cuda")]
    return topo, geom, _operands(topo, geom, cfgs)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 3])
def test_record_walk_on_clusters_matches_twin(card, cluster):
    _, geom, (inj, dst, opts) = _exchange(card, 64, 2, 900)
    assert len(opts["trace"]) == 6
    got = t_noc.run_fused(geom, inj, dst, cluster_size=cluster, **opts)
    want = t_noc.run_plain(geom, inj, dst, **opts)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert (got[4] >= 0).all()


@pytest.mark.cuda
def test_record_walk_matches_twin_at_1024(card):
    """The paper's 1024-PE ring-mesh (C = 3): a MoE layer's dispatch and
    combine through the kernel's record walk equal the twin bit for bit,
    both phases settled."""
    _, geom, (inj, dst, opts) = _exchange(card, 1024, 2, 3000)
    assert t_noc.plan_for(geom, opts["trace"])[0] == 3
    got = t_noc.run_fused(geom, inj, dst, **opts)
    want = t_noc.run_plain(geom, inj, dst, **opts)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert (got[4] >= 0).all()


@pytest.mark.cuda
def test_collective_traces_through_the_record_walk(card):
    """The three mined schedules at 1024 PEs, one record a source: the
    kernel's record walk gives the one-record path's outputs, and the
    one-record path keeps its plan."""
    import os

    from repro_torch import trace as tr
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    topo, geom = _geometry("ring_mesh", 1024, device=card)
    traces = tr.traces_for_schedules(
        1024, os.path.join(root, tr.SCHEDULES_JSON), pod_size=16,
        normalize_flits=8)
    for name, t in traces.items():
        cfg = sim.SimConfig(cycles=4000, warmup=0, inj_rate=1.0, pattern=t,
                            seed=1, device="cuda")
        inj, dst, opts = _operands(topo, geom, [cfg])
        assert t_noc.plan_for(geom, opts["trace"]) == t_noc.cluster_plan(
            7105, 4833, 8, 1024, 0, t.trace.n_phases)
        recs = sim.record_tables([sim.make_point(cfg, 1024, topo)], card)
        want = t_noc.run_fused(geom, inj, dst, **opts)
        got = t_noc.run_fused(geom, inj, dst,
                              **dict(opts, trace=opts["trace"] + recs))
        for x, y in zip(got, want):
            assert torch.equal(x, y), name
        assert (want[4] >= 0).all(), name


# The CPU tests' SSD matrix (tests/test_torch_attention_ssd.py, after the
# reference's tests/test_kernels.py): (B, H, G, S, P, N, chunk).
SSD_CASES = [
    (1, 2, 1, 64, 32, 16, 16),
    (2, 4, 2, 128, 32, 16, 32),
    (1, 4, 1, 128, 64, 32, 64),
    (1, 8, 8, 64, 16, 16, 16),
    (1, 2, 1, 128, 32, 16, 128),
]


def _ssd_on(card, case, seed=0, dtype=BF16):
    x, dt, a, b, c = _ssd_inputs(case, seed)
    return (x.to(card, dtype), dt.to(card), a.to(card), b.to(card, dtype),
            c.to(card, dtype))


def _ssd_close(got, want):
    # 2e-2: outputs rounded to bfloat16 on both sides (chip_smoke.py's TOL)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_bf16_tensor_cores_match_plain(card, case):
    ops = _ssd_on(card, case, seed=case[3] + case[5])
    t_ssd.reset_launches()
    got = t_ssd.ssd_scan(*ops, chunk=case[-1])
    torch.cuda.synchronize()
    assert t_ssd.launches == 1
    _ssd_close(got, t_ssd.plain(*ops, chunk=case[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("s,chunk", [(40, 16), (8, 16), (70, 32), (80, 40)])
def test_ssd_bf16_chunks_that_do_not_tile_by_16(card, s, chunk):
    """Through ``ops.ssd`` (right padding, or the chunk cut to a short
    sequence: S 8 runs one chunk of 8), and a chunk of 40 called
    directly."""
    case = (2, 4, 1, s, 16, 16, chunk)
    ops = _ssd_on(card, case, seed=4)
    want = t_ops.ssd(*ops, chunk=chunk, impl="torch")
    t_ssd.reset_launches()
    got = t_ops.ssd(*ops, chunk=chunk, impl="cuda")
    assert t_ssd.launches == 1 and got.shape == ops[0].shape
    _ssd_close(got, want)


@pytest.mark.cuda
def test_ssd_bf16_widths_that_do_not_tile_by_8(card):
    """P 20 and N 12 are zero-padded to 24 and 16; a misaligned x is
    copied to 16-byte alignment."""
    case = (1, 4, 2, 96, 20, 12, 32)
    x, dt, a, b, c = _ssd_on(card, case, seed=5)
    want = t_ssd.plain(x, dt, a, b, c, chunk=32)
    _ssd_close(t_ssd.ssd_scan(x, dt, a, b, c, chunk=32), want)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
    xs = shifted[1:].view(x.shape)
    xs.copy_(x)
    _ssd_close(t_ssd.ssd_scan(xs, dt, a, b, c, chunk=32), want)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["fast_decay", "slow_decay"])
def test_ssd_bf16_decay_extremes(card, regime):
    """The regimes of tests/test_torch_attention_ssd.py: exp(cum)
    underflows within a chunk and exp(cum_t - cum_u) overflows above the
    diagonal (selected away), or the state barely forgets."""
    case = (1, 4, 2, 64, 16, 16, 32)
    rng = np.random.default_rng(3)
    log_a_scale, dt_shift = (2.5, 3.0) if regime == "fast_decay" \
        else (0.1, -6.0)
    x = rng.standard_normal((1, 4, 64, 16)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((1, 4, 64)) + dt_shift))
    a = -np.exp(rng.standard_normal(4) * log_a_scale)
    if regime == "slow_decay":
        a = a * 1e-3
    b, c = (rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
            for _ in range(2))
    ops = (torch.from_numpy(x).to(card, BF16),
           torch.from_numpy(dt.astype(np.float32)).to(card),
           torch.from_numpy(a.astype(np.float32)).to(card),
           torch.from_numpy(b).to(card, BF16),
           torch.from_numpy(c).to(card, BF16))
    got = t_ssd.ssd_scan(*ops, chunk=case[-1])
    _ssd_close(got, t_ssd.plain(*ops, chunk=case[-1]))


@pytest.mark.cuda
def test_ssd_bf16_d_state_128(card):
    case = (1, 8, 1, 512, 64, 128, 128)  # mamba2-1.3b's N, P and chunk
    ops = _ssd_on(card, case, seed=6)
    _ssd_close(t_ssd.ssd_scan(*ops, chunk=128),
               t_ssd.plain(*ops, chunk=128))


@pytest.mark.cuda
def test_ssd_bf16_every_split_matches_plain(card):
    case = (1, 4, 1, 1024, 64, 64, 128)  # Zamba2's N, P and chunk
    ops = _ssd_on(card, case, seed=7)
    want = t_ssd.plain(*ops, chunk=128)
    ks = t_ssd.splits(128, 64, 64, BF16)
    assert ks == [1, 2, 4, 8]
    for k in ks:
        _ssd_close(t_ssd.ssd_scan(*ops, chunk=128, split=k), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 8, 1, 512, 64, 128, 128),
                                  (2, 4, 1, 256, 64, 64, 128)])
def test_ssd_float32_every_split_matches_plain(card, case):
    """The scalar kernel split over k blocks per (b, h): at mamba2-1.3b's
    d_state 128 (k = 2 at the least) and at Zamba2's 64."""
    ops = _ssd_on(card, case, seed=10, dtype=F32)
    want = t_ssd.plain(*ops, chunk=case[-1])
    for k in t_ssd.splits(case[-1], case[5], case[4], F32)[:3]:
        torch.testing.assert_close(
            t_ssd.ssd_scan(*ops, chunk=case[-1], split=k), want,
            atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
def test_ssd_float32_keeps_the_scalar_kernel(card):
    case = SSD_CASES[2]
    ops = _ssd_on(card, case, seed=9, dtype=F32)
    got = t_ssd.ssd_scan(*ops, chunk=case[-1])
    torch.testing.assert_close(got, t_ssd.plain(*ops, chunk=case[-1]),
                               atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2.5-14b",
                                  "command-r-plus-104b", "h2o-danube-1.8b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e", "mamba2-1.3b"])
def test_zoo_smoke_forward_matches_plain_route(card, arch):
    """One cache-free forward at smoke size launches one kernel per layer
    and stays within the bfloat16 limits of the plain route (0.3 on
    hidden states where a MoE token may be routed elsewhere)."""
    from repro_torch import configs
    from repro_torch.models import config as t_config
    from repro_torch.models import model as t_model
    cfg = t_config.smoke_config(configs.get(arch))
    params = t_model.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 64), device=card,
                        generator=torch.Generator("cuda").manual_seed(1))
    t_flash.reset_launches()
    t_ssd.reset_launches()
    hk, aux_k, *_ = t_model.forward(cfg, params, tok)
    mamba = cfg.family == "ssm"
    assert (t_flash.launches, t_ssd.launches) == (
        (0, cfg.n_layers) if mamba else (cfg.n_layers, 0))
    hp, aux_p, *_ = t_model.forward(
        dataclasses.replace(cfg, attn_impl="torch"), params, tok)
    torch.testing.assert_close(hk.float(), hp.float(),
                               atol=0.3 if cfg.moe else 0.1, rtol=2e-2)
    assert abs(float(aux_k) - float(aux_p)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_forward", [("whisper-small", 6),
                                              ("llama-3.2-vision-11b", 3)])
def test_zoo_cross_smoke_forward_matches_plain_route(card, arch,
                                                     per_forward):
    """The cross-attention models at smoke size: a cache-free forward
    launches the kernel for every self-attention, cross-attention and
    encoder layer, over a memory that does not tile by 128, and stays
    within the bfloat16 limits of the plain route."""
    from repro_torch import configs
    from repro_torch.models import config as t_config
    from repro_torch.models import model as t_model
    cfg = t_config.smoke_config(configs.get(arch))
    params = t_model.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 45), device=card, generator=gen)
    key = "frames" if cfg.encoder_layers else "img_embeds"
    mem = torch.randn((2, cfg.encoder_seq or cfg.n_img_tokens, cfg.d_model),
                      device=card, generator=gen).to(torch.bfloat16)
    t_flash.reset_launches()
    hk, *_ = t_model.forward(cfg, params, tok, **{key: mem})
    assert t_flash.launches == per_forward
    hp, *_ = t_model.forward(dataclasses.replace(cfg, attn_impl="torch"),
                             params, tok, **{key: mem})
    torch.testing.assert_close(hk.float(), hp.float(), atol=0.1, rtol=2e-2)


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(card):
    """The kernels have no backward: on CUDA tensors that require grad the
    wrappers raise rather than hand autograd an output it cannot see
    through; under no_grad they launch."""
    q = torch.randn(1, 2, 45, 64, device=card, dtype=torch.bfloat16)
    k = torch.randn(1, 2, 93, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        t_flash.flash_attention(q.clone().requires_grad_(), k, k,
                                causal=False)
    x = torch.randn(1, 2, 128, 64, device=card, requires_grad=True)
    b = torch.randn(1, 1, 128, 16, device=card)
    dt, a = torch.rand(1, 2, 128, device=card), -torch.rand(2, device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        t_ssd.ssd_scan(x, dt, a, b, b, chunk=64)
    with torch.no_grad():
        t_ssd.ssd_scan(x, dt, a, b, b, chunk=64)
