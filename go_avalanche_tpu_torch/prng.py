"""Threefry-2x32 counter-based randomness, bit-exact with `jax.random`.

Trajectory parity with the JAX reference needs jax's own bits, which no
`torch.Generator` gives, so this module re-implements jax's default PRNG
in its *partitionable* mode (`jax_threefry_partitionable=True`):

  * a key is a ``[2]`` int64 tensor of the two uint32 key words (what
    `jax.random.key_data` returns for a threefry key);
  * `split` hashes the 64-bit iota counter ``(i >> 32, i & M)`` of the
    output shape; `random_bits` does the same over the sample shape and
    returns ``bits1 ^ bits2``;
  * `fold_in` hashes the counter pair ``(0, data)``;
  * `randint`, `uniform` and `bernoulli` follow jax's recipes
    (`jax/_src/random.py`) step for step.

All uint32 arithmetic runs in int64 masked to 32 bits: torch has no
shifts or adds on uint32 tensors on the CPU.  Everything stays on the
key's device; nothing syncs with the host.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device="cuda") -> torch.Tensor:
    """`jax.random.key(seed)` as its two key words, ``[0, seed]``: with
    64-bit mode off (jax's default) the seed is a 32-bit value, so the
    port takes seeds in [0, 2**32) only."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counter pair
    ``(x0, x1)`` under key words ``k``; uint32 values in int64."""
    k0, k1 = k[0], k[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _iota_2x32(shape: Sequence[int], device) -> tuple:
    """The row-major 64-bit iota of `shape` as (high, low) uint32 words."""
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=device).reshape(tuple(shape))
    return count >> 32, count & _M32


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` (fold-like, partitionable): ``[num, 2]`` keys."""
    hi, lo = _iota_2x32((num,), k.device)
    b0, b1 = threefry2x32(k, hi, lo)
    return torch.stack([b0, b1], dim=1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in`: hash the counter pair ``(0, data)``."""
    counter = torch.tensor([0, int(data) & _M32], dtype=torch.int64,
                           device=k.device)
    b0, b1 = threefry2x32(k, counter[:1], counter[1:])
    return torch.cat([b0, b1])


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64)."""
    hi, lo = _iota_2x32(shape, k.device)
    b0, b1 = threefry2x32(k, hi, lo)
    return b0 ^ b1


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval, jnp.int32)`:
    two 32-bit streams from `split(key)` folded through
    ``(2**32 mod span)`` so the modulus sees 64 random bits."""
    if not (-(1 << 31) <= minval and maxval <= (1 << 31) - 1):
        raise ValueError("randint bounds must fit in int32")
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = 1 if maxval <= minval else maxval - minval
    multiplier = ((((1 << 16) % span) ** 2) & _M32) % span  # uint32 wrap
    offset = (((higher % span) * multiplier) & _M32) + (lower % span)
    offset = (offset & _M32) % span
    return (offset + minval).to(torch.int32)


def uniform(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.uniform` on [0, 1) in float32: the top 23 bits become
    the mantissa of a float in [1, 2), minus one.  (Other ranges are not
    ported: XLA fuses jax's scale-and-shift into one rounding, which two
    torch ops do not reproduce.)"""
    bits = random_bits(k, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return floats - 1.0


def bernoulli(k: torch.Tensor, p: float,
              shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bernoulli` (mode 'low'): ``uniform < float32(p)``."""
    return uniform(k, shape) < torch.tensor(p, dtype=torch.float32,
                                            device=k.device)
