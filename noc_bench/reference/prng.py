"""JAX's threefry-2x32 random streams on torch tensors, frozen from the port.

``key``, ``split``, ``uniform``, ``bernoulli`` and ``randint`` give the bits
that ``jax.random`` gives for the same key, so the reference draws the same
injection and destination streams as the program for the same seed.
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
