"""The streams kernel (``kernels/streams.py``, ``csrc/streams.cu``): what
the CPU can check, and its runs on the card.

On the CPU: ``draw_streams`` on a CPU device takes the plain version and
counts its batches under ``streams.launches[plain]``; the host's point
table holds each point's key word, injection rate, permutation flag and
permutation, the packet spans are the ringlet and block spans the kernel
folds by, and the table holds the float32 sum of the two locality
thresholds, bit for bit, as the plain version takes it; ``launch`` refuses
CPU tensors, a wrong dtype and an output that is not contiguous.

On the card (``cuda``-marked, skipped here): the fused draw against the
plain version on the card, bit for bit in all three outputs, over the §7
grid's 12 points at 1024 PEs x 1500 cycles under the paper's locality and
under none, permutation and uniform points in one batch, faulted batches
of F = 1, 4 and 8, batches of 1 and 40 points, 64 PEs x 120 cycles and a
ragged 18 PEs x 7 cycles (the packet constants give every fabric a
multiple of 16 PEs; ``draw_streams`` takes any), seeds 0, 2^31 - 1 and
negative ones, injection rates 0 and 1.  This file imports no jax, so on
the card it runs without the suite's conftest::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_streams_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs.ringmesh_noc import CONFIG
from repro_torch.core import packet as pk
from repro_torch.core import prng
from repro_torch.core import sim
from repro_torch.core import traffic
from repro_torch.kernels import streams

torch.set_num_threads(1)


def _points(n_pes, patterns, rates, seeds, loc=(0.75, 0.20), n_faults=0):
    """One point per (pattern, rate, seed) triple, ``n_faults`` fault
    entries each (the draw reads only their count)."""
    points = []
    for pattern, rate, seed in zip(patterns, rates, seeds):
        cfg = sim.SimConfig(
            cycles=2, warmup=0, inj_rate=rate, seed=seed, backend="torch",
            device="cpu", pattern=traffic.spec(
                pattern, locality_ringlet=loc[0], locality_block=loc[1]))
        pt = sim.make_point(cfg, n_pes)
        if n_faults:
            pt = dataclasses.replace(
                pt, fault_links=np.zeros(n_faults, np.int32),
                fault_drop_p=np.zeros(n_faults, np.float32),
                fault_onset=np.zeros(n_faults, np.int32))
        points.append(pt)
    return points


def _cycle(values, n):
    return [values[i % len(values)] for i in range(n)]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------
def test_draw_streams_on_the_cpu_takes_the_plain_version():
    points = _points(16, ("uniform", "transpose"), (0.5, 1.0), (3, -7),
                     n_faults=2)
    telemetry.drain()
    got = sim.draw_streams(points, 16, 20, "cpu")
    assert streams.launches() == {"fused": 0, "plain": 1}
    assert telemetry.counter("streams.points") == 2
    want = sim._draw_streams_plain(points, 16, 20, torch.device("cpu"))
    assert streams.launches() == {"fused": 0, "plain": 2}
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and torch.equal(a, b)
    telemetry.drain()


@pytest.mark.parametrize("n_pes", (64, 1024, 18))
def test_point_table_holds_what_prng_folds_by(n_pes):
    points = _points(n_pes, ("uniform", "transpose" if n_pes != 18
                             else "uniform"), (0.25, 1.0),
                     (2**31 - 1, -123456789), loc=(0.1, 0.3))
    table = streams.point_table(points, n_pes)
    assert table.dtype == np.int32
    assert table.shape == (2, streams.HEADER + n_pes)
    # csrc/streams.cu folds the ringlet and block draws by these spans.
    assert (pk.PES_PER_RINGLET - 1, pk.PES_PER_BLOCK - 1) == (3, 15)
    assert table[:, streams.SEED].tolist() == [2**31 - 1, -123456789]
    # The kernel's key is (0, that word), as core.prng keys a seed.
    for word, pt in zip(table[:, streams.SEED], points):
        assert prng.key(pt.seed, "cpu").tolist() == [
            0, int(word.view(np.uint32))]
    assert table[:, streams.INJ_RATE].view(np.float32).tolist() == [0.25,
                                                                     1.0]
    assert table[:, streams.USE_PERM].tolist() == [0, int(n_pes != 18)]
    for row, pt in zip(table, points):
        assert np.array_equal(row[streams.HEADER:], pt.perm_dst)


def test_point_table_sums_the_thresholds_as_the_plain_version():
    rng = np.random.default_rng(26)
    pairs = [(0.75, 0.20), (0.1, 0.3), (0.0, 0.0), (0.7, 0.3)] + [
        tuple(rng.uniform(0, 0.5, 2)) for _ in range(200)]
    points = []
    for ring, block in pairs:
        pt = _points(64, ("uniform",), (0.5,), (1,), loc=(ring, block))[0]
        points.append(pt)
    table = streams.point_table(points, 64)
    f32 = dict(dtype=torch.float32)
    for row, pt in zip(table, points):
        loc_ring = torch.tensor(pt.loc_ring, **f32)
        loc_both = loc_ring + torch.tensor(pt.loc_block, **f32)
        assert row[streams.LOC_RING] == int(loc_ring.view(torch.int32))
        assert row[streams.LOC_BOTH] == int(loc_both.view(torch.int32))


def _refusal_operands(case):
    table = torch.zeros((2, streams.HEADER + 16), dtype=torch.int32)
    inj = torch.empty((2, 5, 16), dtype=torch.bool)
    dst = torch.empty((2, 5, 16), dtype=torch.int16)
    fault_u = torch.empty((2, 5, 3), dtype=torch.float32)
    if case == "dtype":
        dst = dst.to(torch.int32)
    elif case == "contiguous":
        inj = torch.empty((2, 16, 5), dtype=torch.bool).transpose(1, 2)
    elif case == "fault dtype":
        fault_u = fault_u.double()
    return table, inj, dst, fault_u


@pytest.mark.parametrize("case,message", [
    ("cpu", "CUDA tensors"), ("dtype", "torch.int16"),
    ("contiguous", "contiguous"), ("fault dtype", "torch.float32")])
def test_launch_refuses_what_the_kernel_does_not_take(case, message):
    telemetry.drain()
    with pytest.raises(ValueError, match=message):
        streams.launch(*_refusal_operands(case))
    assert streams.launches()["fused"] == 0


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the streams kernel has no CPU mode")
    return torch.device("cuda")


def _assert_fused_equals_plain(points, n_pes, cycles, dev):
    telemetry.drain()
    inj, dst, fault_u = sim.draw_streams(points, n_pes, cycles, dev)
    assert streams.launches() == {"fused": 1, "plain": 0}
    p_inj, p_dst, p_fault_u = sim._draw_streams_plain(points, n_pes, cycles,
                                                      dev)
    torch.cuda.synchronize()
    assert inj.shape == (len(points), cycles, n_pes)
    assert inj.dtype == torch.bool and dst.dtype == torch.int16
    assert torch.equal(inj, p_inj)
    assert torch.equal(dst, p_dst)
    if p_fault_u is None:
        assert fault_u is None
    else:
        assert fault_u.dtype == torch.float32
        assert torch.equal(fault_u.view(torch.int32),
                           p_fault_u.view(torch.int32))
    telemetry.drain()


@pytest.mark.cuda
@pytest.mark.parametrize("loc", [(CONFIG.locality_ringlet,
                                  CONFIG.locality_block), (0.0, 0.0)],
                         ids=str)
def test_fused_draw_of_the_paper_grid(card, loc):
    grid = [(p, r) for r in CONFIG.injection_rates for p in CONFIG.patterns]
    seeds = np.random.default_rng(7).integers(0, 2**31 - 1, len(grid))
    points = _points(1024, [p for p, _ in grid], [r for _, r in grid],
                     seeds.tolist(), loc=loc)
    assert len(points) == 12 and sum(pt.use_perm for pt in points) == 8
    _assert_fused_equals_plain(points, 1024, CONFIG.cycles, card)


@pytest.mark.cuda
@pytest.mark.parametrize("n_faults", (1, 4, 8))
def test_fused_draw_of_faulted_batches(card, n_faults):
    points = _points(64, ("uniform", "transpose", "bit_reversal"),
                     (0.02, 0.5, 1.0), (11, -3, 2**31 - 1),
                     n_faults=n_faults)
    _assert_fused_equals_plain(points, 64, 120, card)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", (1, 40))
def test_fused_draw_of_one_and_forty_points(card, batch):
    seeds = _cycle([0, 2**31 - 1, -1, -2**31, 5], batch)
    rates = _cycle([0.0, 1.0, 0.3, 0.625], batch)
    patterns = _cycle(["uniform", "transpose", "bit_reversal", "hotspot"],
                      batch)
    points = _points(64, patterns, rates, seeds)
    _assert_fused_equals_plain(points, 64, 120, card)


@pytest.mark.cuda
@pytest.mark.parametrize("n_faults", (0, 3))
def test_fused_draw_of_a_ragged_stream(card, n_faults):
    # 18 PEs x 7 cycles: 126 elements, so whole-word stores stop short and
    # the tail is stored element by element.
    points = _points(18, ("uniform",) * 3, (0.0, 1.0, 0.4),
                     (0, -99, 2**31 - 1), loc=(0.3, 0.3), n_faults=n_faults)
    _assert_fused_equals_plain(points, 18, 7, card)
