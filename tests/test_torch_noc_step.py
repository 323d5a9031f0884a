"""The port's ``noc_step`` twin vs the reference's fused Pallas kernel.

Both run the same numpy-made traffic streams on the reference's own
geometry arrays, carried across with ``geometry_from_arrays``, so this
holds the cycle math alone, apart from topology and stream parity.  The
reference kernel runs in interpret mode on the CPU, as its own tests run
it.  Tolerance: exact (every accumulator is int32).

The CUDA kernel itself runs only on the card: ``test_cuda_kernel_matches
_twin`` is marked ``cuda`` and skips here, and ``run_fused`` raises on CPU
tensors; ``chip_smoke.py`` holds the kernel against the twin over the full
matrix on the H100.
"""
import numpy as np
import pytest
import torch

from repro.core import sim as r_sim
from repro.core import spec as r_spec
from repro.core import topology as r_topo
from repro.kernels import noc_step as r_noc
from repro_torch import telemetry
from repro_torch.core import sim as t_sim
from repro_torch.kernels import noc_step as t_noc

torch.set_num_threads(1)

KW = dict(warmup=20, starvation_limit=8, arb_iters=r_sim.ARB_ITERS)


def _streams(n_pes, cycles, rate, seed, batch=1, hot=False):
    rng = np.random.default_rng(seed)
    inj = rng.random((batch, cycles, n_pes)) < rate
    if hot:  # everyone to a few PEs: full queues, drops and deep fixpoints
        dst = rng.integers(0, 3, (batch, cycles, n_pes))
    else:
        dst = rng.integers(0, n_pes, (batch, cycles, n_pes))
    return inj, dst.astype(np.int16)


def _reference(rgeom, inj, dst, diagnostics=False):
    ql, m_scal, m_kind = r_noc.run_fused(
        rgeom, inj, dst, cycles=inj.shape[0], diagnostics=diagnostics,
        interpret=True, **KW)
    return np.asarray(ql), np.asarray(m_scal), np.asarray(m_kind)


def _carried(rgeom):
    return t_sim.geometry_from_arrays(
        {k: np.asarray(getattr(rgeom, k)) for k in t_sim.GEOMETRY_ARRAYS},
        depth=rgeom.depth, cap_total=rgeom.cap_total, device="cpu")


def _topology(case):
    if case == "morph":
        spec = r_spec.TopologySpec("ring_mesh", 16, morphs=(
            r_spec.MorphOverlay(hl=1, target=0,
                                link_states=(0, 0, 0, 0, 2, 0, 0, 0)),))
        return spec.build()
    family, n = case.rsplit("_", 1)
    return r_topo.build(family, int(n))


@pytest.mark.parametrize("case,rate,hot", [
    ("ring_mesh_16", 0.3, False), ("ring_mesh_16", 1.0, True),
    ("flat_mesh_16", 0.3, False), ("flat_mesh_16", 1.0, True),
    ("morph", 0.5, False), ("ring_mesh_64", 0.6, False)])
def test_twin_matches_reference_kernel(case, rate, hot):
    rgeom = r_sim.build_geometry(_topology(case))
    cycles = 80
    inj, dst = _streams(rgeom.n_pes, cycles, rate, seed=len(case), hot=hot)
    ql, m_scal, m_kind = _reference(rgeom, inj[0], dst[0])
    tq, ts, tk, passes, _ = t_noc.run_plain(
        _carried(rgeom), torch.from_numpy(inj), torch.from_numpy(dst), **KW)
    assert np.array_equal(tq[0].numpy(), ql)
    assert np.array_equal(ts[0].numpy(), m_scal)
    assert np.array_equal(tk[0].numpy(), m_kind)
    assert m_scal[r_noc.LOST] == 0 and m_scal[r_noc.DELIVERED] > 0
    assert int(passes[0]) >= cycles
    if hot:  # the fixpoint really re-arbitrated
        assert int(passes[0]) > cycles


def test_twin_diagnostics_match_reference_kernel():
    rgeom = r_sim.build_geometry(r_topo.build("flat_mesh", 16))
    inj, dst = _streams(16, 60, 0.7, seed=3)
    ql, m_scal, m_kind = _reference(rgeom, inj[0], dst[0], diagnostics=True)
    tq, ts, tk, _, _ = t_noc.run_plain(
        _carried(rgeom), torch.from_numpy(inj), torch.from_numpy(dst),
        diagnostics=True, **KW)
    assert np.array_equal(ts[0].numpy(), m_scal)
    assert np.array_equal(tk[0].numpy(), m_kind)
    assert m_kind[r_noc.KIND_WINS].sum() > 0


def test_batched_twin_equals_per_point():
    """The batch dimension written out: a batch of three points gives each
    point's own result, including its own count of arbitration passes."""
    geom = _carried(r_sim.build_geometry(r_topo.build("ring_mesh", 16)))
    inj, dst = _streams(16, 70, 0.8, seed=9, batch=3, hot=True)
    inj[1] = False  # an idle point beside busy ones
    full = t_noc.run_plain(geom, torch.from_numpy(inj),
                           torch.from_numpy(dst), **KW)
    for b in range(3):
        one = t_noc.run_plain(geom, torch.from_numpy(inj[b:b + 1]),
                              torch.from_numpy(dst[b:b + 1]), **KW)
        for x, y in zip(full, one):
            assert torch.equal(x[b], y[0])


def test_run_fused_on_cpu_runs_the_twin():
    """The wrapper never gives way to the plain version: on CPU tensors it
    raises, naming ``run_plain``, which is the CPU's path; nothing is
    launched and nothing is counted."""
    geom = _carried(r_sim.build_geometry(r_topo.build("flat_mesh", 16)))
    inj, dst = _streams(16, 40, 0.5, seed=1, batch=2)
    telemetry.drain()
    with pytest.raises(ValueError, match="run_plain"):
        t_noc.run_fused(geom, torch.from_numpy(inj), torch.from_numpy(dst),
                        **KW)
    assert not any(t_noc.launches().values())  # no kernel ran
    out = t_noc.run_plain(geom, torch.from_numpy(inj), torch.from_numpy(dst),
                          **KW)
    assert out[4].shape == (2, 0)  # statistical traffic: no phases


def test_geometry_from_arrays_checks_inject_rows():
    rgeom = r_sim.build_geometry(r_topo.build("ring_mesh", 16))
    arrays = {k: np.asarray(getattr(rgeom, k)).copy()
              for k in t_sim.GEOMETRY_ARRAYS}
    arrays["inj_pe"][0], arrays["inj_pe"][1] = 3, 3
    with pytest.raises(ValueError, match="inj_pe"):
        t_sim.geometry_from_arrays(arrays, depth=rgeom.depth,
                                   cap_total=rgeom.cap_total, device="cpu")


@pytest.mark.cuda
def test_cuda_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rgeom = r_sim.build_geometry(r_topo.build("ring_mesh", 64))
    geom = t_sim.geometry_from_arrays(
        {k: np.asarray(getattr(rgeom, k)) for k in t_sim.GEOMETRY_ARRAYS},
        depth=rgeom.depth, cap_total=rgeom.cap_total, device="cuda")
    inj, dst = _streams(64, 200, 0.9, seed=2, batch=3, hot=True)
    inj_t, dst_t = torch.from_numpy(inj).cuda(), torch.from_numpy(dst).cuda()
    got = t_noc.run_fused(geom, inj_t, dst_t, diagnostics=True, **KW)
    torch.cuda.synchronize()
    want = t_noc.run_plain(geom, inj_t, dst_t, diagnostics=True, **KW)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
