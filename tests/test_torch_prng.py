"""``repro_torch.core.prng`` vs ``jax.random``: every stream the
simulator draws, elementwise equal for several seeds and shapes.

The reference draws its traffic with jax's default threefry2x32 generator
(partitionable mode); a seed must give the port the very same bits, so the
tolerance is exact.  ``draw_streams`` is then held against the streams the
reference's ``_run_core`` builds from them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packet as r_pk
from repro_torch.core import prng
from repro_torch.core import sim as t_sim
from repro_torch.core import traffic as t_traffic

torch.set_num_threads(1)

SEEDS = (0, 1, 7, 2**31 - 1, -5)
SHAPES = ((1, 16), (300, 16), (37, 64), (9, 1024))


def _keys(seed):
    k = jax.random.PRNGKey(np.int32(seed))
    return k, prng.key(seed, "cpu")


def test_threefry_partitionable_is_the_default():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    k, tk = _keys(seed)
    assert np.array_equal(np.asarray(k).astype(np.int64), tk.numpy())
    for n in (2, 5, 6):
        assert np.array_equal(np.asarray(jax.random.split(k, n)),
                              prng.split(tk, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_streams_equal(seed, shape):
    k, tk = _keys(seed)
    keys, tkeys = jax.random.split(k, 5), prng.split(tk, 5)
    for i in range(5):
        a = jax.random.uniform(keys[i], shape)
        assert np.array_equal(np.asarray(a), prng.uniform(tkeys[i],
                                                          shape).numpy())
        for p in (0.0, 0.25, 0.625, 1.0):
            p32 = np.float32(p)
            a = jax.random.bernoulli(keys[i], p32, shape)
            b = prng.bernoulli(tkeys[i], torch.tensor(p32), shape)
            assert np.array_equal(np.asarray(a), b.numpy())
        for lo, hi in ((1, shape[1]), (1, r_pk.PES_PER_RINGLET),
                       (1, r_pk.PES_PER_BLOCK)):
            a = jax.random.randint(keys[i], shape, lo, hi, dtype=jnp.int32)
            b = prng.randint(tkeys[i], shape, lo, hi)
            assert b.dtype == torch.int32
            assert np.array_equal(np.asarray(a), b.numpy()), (lo, hi)


def _reference_streams(point, n_pes, cycles):
    """The stream block of the reference's ``sim._run_core``
    (core/sim.py:521-555), on the reference's own ops."""
    P = n_pes
    pes = jnp.arange(P, dtype=jnp.int32)
    ring_base = pes - pes % r_pk.PES_PER_RINGLET
    pos_ring = pes % r_pk.PES_PER_RINGLET
    blk_base = pes - pes % r_pk.PES_PER_BLOCK
    pos_blk = pes % r_pk.PES_PER_BLOCK
    key = jax.random.PRNGKey(np.int32(point.seed))
    k_inj, k_dst, k_loc, k_ring, k_blk = jax.random.split(key, 5)
    inj_s = jax.random.bernoulli(k_inj, point.inj_rate, (cycles, P))
    off_s = jax.random.randint(k_dst, (cycles, P), 1, P, dtype=jnp.int32)
    u_s = jax.random.uniform(k_loc, (cycles, P))
    ring_s = jax.random.randint(k_ring, (cycles, P), 1,
                                r_pk.PES_PER_RINGLET, dtype=jnp.int32)
    blk_s = jax.random.randint(k_blk, (cycles, P), 1, r_pk.PES_PER_BLOCK,
                               dtype=jnp.int32)
    base_s = (pes[None, :] + off_s) % P
    base_s = jnp.where(point.use_perm,
                       jnp.broadcast_to(point.perm_dst, (cycles, P)), base_s)
    ring_peer = ring_base + (pos_ring[None, :] + ring_s) % \
        r_pk.PES_PER_RINGLET
    blk_peer = blk_base + (pos_blk[None, :] + blk_s) % r_pk.PES_PER_BLOCK
    loc_ring = jnp.float32(point.loc_ring)
    loc_block = jnp.float32(point.loc_block)
    dst_s = jnp.where(u_s < loc_ring, ring_peer,
                      jnp.where(u_s < loc_ring + loc_block, blk_peer,
                                base_s)).astype(jnp.int16)
    return np.asarray(inj_s), np.asarray(dst_s)


@pytest.mark.parametrize("pattern,loc", [
    ("uniform", (0.0, 0.0)), ("uniform", (0.75, 0.20)),
    ("transpose", (0.1, 0.3)), ("hotspot", (0.0, 0.0))])
def test_draw_streams_match_reference(pattern, loc):
    n, cycles = 64, 120
    cfgs = [t_sim.SimConfig(cycles=cycles, warmup=0, inj_rate=rate,
                            seed=seed, backend="torch", device="cpu",
                            pattern=t_traffic.spec(
                                pattern, locality_ringlet=loc[0],
                                locality_block=loc[1]))
            for rate, seed in ((0.3, 3), (0.625, 11))]
    points = [t_sim.make_point(c, n) for c in cfgs]
    inj, dst, fault_u = t_sim.draw_streams(points, n, cycles, "cpu")
    assert inj.dtype == torch.bool and dst.dtype == torch.int16
    assert fault_u is None  # healthy points: no fault draws
    for b, pt in enumerate(points):
        r_inj, r_dst = _reference_streams(pt, n, cycles)
        assert np.array_equal(inj[b].numpy(), r_inj)
        assert np.array_equal(dst[b].numpy(), r_dst)
