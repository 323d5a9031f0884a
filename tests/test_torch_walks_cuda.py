"""Route walks on the card: ``core.topology.walk_classify`` doubles its
pointer table with ``torch.gather`` on the card when there is one, and
``reroute_avoiding`` walks twice through it.

On the card (``cuda``-marked, skipped here), at 1024 PEs on both
families with 2, 4 and 8 sampled dead links: the walk equals the plain
numpy walk of ``noc_bench/reference/topology.py`` on every (queue, dest)
row, ``reroute_avoiding``'s ``(route, reachable)`` equals that
reference's bit for bit, and every walk is counted under
``topology.walks[cuda]``; one walk's time on the card is printed beside
the numpy walk's.  The CPU's parity with the JAX package is
``tests/test_torch_analysis.py::test_walk_classify_and_reroute_equal_reference``.
This file imports no jax, so on the card it runs without the suite's
conftest::

    PYTHONPATH=src python -m pytest --noconftest -m cuda -s \\
        tests/test_torch_walks_cuda.py
"""
import statistics
import time

import numpy as np
import pytest
import torch

from noc_bench.reference import topology as r_topo
from repro_torch import telemetry
from repro_torch.core import topology
from repro_torch.core.spec import TopologySpec
from repro_torch.faults import sample_faults

N_PES = 1024


def _fabrics(family):
    """The port's fabric and the reference's, with equal route tables."""
    spec = TopologySpec(family, N_PES)
    topo = spec.build_fresh()
    ref = r_topo.build(family, N_PES, spec.queue_depth,
                       spec.src_queue_depth)
    assert np.array_equal(topo.route_table, ref.route_table)
    return topo, ref


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walks take the card only "
                    "where there is one")


@pytest.mark.cuda
@pytest.mark.parametrize("n_dead", [2, 4, 8])
@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_walks_on_the_card_equal_the_numpy_reference(family, n_dead):
    _needs_card()
    topo, ref = _fabrics(family)
    dead = sample_faults(topo, n_dead_links=n_dead,
                         seed=2**31 + n_dead).dead_queue_mask(topo)
    telemetry.drain()
    got = topology.walk_classify(topo.route_table, topo.is_sink, dead)
    route, reach = topology.reroute_avoiding(topo, dead)
    assert telemetry.counter("topology.walks[cuda]") == 3
    assert telemetry.counter("topology.walks[cpu]") == 0
    assert np.array_equal(
        got, r_topo._walk_classify(ref.route_table, ref.is_sink, dead))
    want_route, want_reach = r_topo.reroute_avoiding(ref, dead)
    assert route.dtype == want_route.dtype
    assert np.array_equal(route, want_route)
    assert np.array_equal(reach, want_reach)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ring_mesh", "flat_mesh"])
def test_walk_time_on_the_card_beside_numpy(family):
    """Prints one walk's time (median of 5, after one warm-up) on the card,
    upload and copy back included, and the numpy reference's."""
    _needs_card()
    topo, ref = _fabrics(family)
    dead = sample_faults(topo, n_dead_links=4, seed=7).dead_queue_mask(topo)

    def median_ms(fn, runs):
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def card():
        return topology.walk_classify(topo.route_table, topo.is_sink, dead)

    card()
    card_ms = median_ms(card, 5)
    numpy_ms = median_ms(lambda: r_topo._walk_classify(
        ref.route_table, ref.is_sink, dead), 3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"\nwalk_classify {family} {N_PES} PEs, {topo.n_links} queues, "
          f"4 dead links on {torch.cuda.get_device_name()}: card "
          f"{card_ms:.3f} ms, numpy {numpy_ms:.1f} ms, "
          f"peak {peak} B above the walk's start")
    assert card_ms < numpy_ms
