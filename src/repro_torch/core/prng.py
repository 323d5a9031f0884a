"""Counter-based random streams that reproduce the reference simulator's.

The reference draws its traffic with ``jax.random`` (``core/sim.py``
``_run_core``): a ``threefry2x32`` key from the point's seed, split five
ways, then one Bernoulli injection stream, three ``randint`` streams and
one ``uniform`` stream of shape ``[cycles, n_pes]``.  A seed must give the
same traffic here, so these functions re-implement exactly that path as
jax 0.9.0 runs it by default (``jax_threefry_partitionable=True``):

* the hash is Threefry-2x32 with 20 rounds (Salmon et al., SC'11);
* a key is a pair of uint32 words; ``split(key, n)`` hashes the 64-bit
  counters ``0..n-1`` (high word, low word) under ``key``;
* ``random_bits(key, shape)`` hashes the row-major flat index of every
  element as a 64-bit counter and XORs the two output words;
* ``uniform`` keeps the top 23 bits as a float32 mantissa in ``[1, 2)``
  and subtracts 1; ``bernoulli(p)`` is ``uniform < p`` in float32;
* ``randint(lo, hi)`` splits its key in two, draws 32 bits from each and
  folds them as ``((hi_bits % span) * (2^32 % span) + lo_bits % span) %
  span`` — all in uint32, which never overflows for the spans used here.

Everything is plain tensor math on the caller's device.  The uint32 words
are held in int64 tensors and masked with ``& 0xFFFFFFFF`` after each add
and shift, since torch has no full uint32 arithmetic.  A key is an int64
tensor of shape ``[2]`` (or ``[n, 2]`` for a split), so drawing never
leaves the device.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key words ``(k0, k1)``.  All four are int64 tensors holding uint32
    values; the keys broadcast against the counters."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey`` of an int32 seed: the words are
    ``(seed >> 32, seed & 0xFFFFFFFF)`` with a logical shift of a 32-bit
    value, so the high word is always 0."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit iota ``0..n-1`` as (high, low) uint32 words."""
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, iota & MASK32


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(k, num)``: an int64 ``[num, 2]`` key array."""
    hi, lo = _counters(num, k.device)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([b0, b1], dim=1)


def random_bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64)."""
    hi, lo = _counters(math.prod(shape), k.device)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 uniforms in ``[0, 1)``, bit-identical to
    ``jax.random.uniform(k, shape)``."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k: torch.Tensor, p: torch.Tensor,
              shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` for a float32 scalar ``p``."""
    return uniform(k, shape) < p


def randint(k: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)``, bit-identical to
    ``jax.random.randint(k, shape, minval, maxval, dtype=int32)``."""
    sub = split(k, 2)
    higher = random_bits(sub[0], shape)
    lower = random_bits(sub[1], shape)
    span = max(maxval - minval, 1)
    mult = ((1 << 16) % span) ** 2 % span
    off = ((((higher % span) * mult) & MASK32) + lower % span) & MASK32
    off = off % span
    return (off + minval).to(torch.int32)
