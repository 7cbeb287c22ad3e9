"""Threefry-2x32 counter-based randomness, as `jax.random` defines it in
its partitionable mode: the plain reference's own copy, frozen.

A key is a ``[2]`` int64 tensor of two uint32 words.  `split` hashes the
64-bit iota ``(i >> 32, i & M)`` of the output shape, `random_bits`
the same over the sample shape (``bits1 ^ bits2``), `fold_in` the pair
``(0, data)``.  `randint` folds two 32-bit streams through
``2**32 mod span``; `uniform` puts the top 23 bits into a float32
mantissa.  uint32 arithmetic runs in int64 masked to 32 bits.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_from_words(hi: int, lo: int, device) -> torch.Tensor:
    """The key whose two uint32 words are `hi`, `lo`."""
    return torch.tensor([hi & M32, lo & M32], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """20 rounds of Threefry-2x32 over the counter pair ``(x0, x1)``."""
    k0, k1 = k[0], k[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _iota(shape: Sequence[int], device):
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=device).reshape(tuple(shape))
    return count >> 32, count & M32


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``[num, 2]`` keys."""
    hi, lo = _iota((num,), k.device)
    b0, b1 = threefry2x32(k, hi, lo)
    return torch.stack([b0, b1], dim=1)


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element, as uint32 values in int64."""
    hi, lo = _iota(shape, k.device)
    b0, b1 = threefry2x32(k, hi, lo)
    return b0 ^ b1


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 uniform on [minval, maxval)."""
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = max(1, maxval - minval)
    multiplier = ((((1 << 16) % span) ** 2) & M32) % span
    offset = (((higher % span) * multiplier) & M32) + (lower % span)
    offset = (offset & M32) % span
    return (offset + minval).to(torch.int32)


def uniform(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 uniform on [0, 1): the top 23 bits as a mantissa of a
    float in [1, 2), minus one."""
    bits = random_bits(k, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(floats - 1.0, 0.0)


def bernoulli(k: torch.Tensor, p: float,
              shape: Sequence[int]) -> torch.Tensor:
    """``uniform < float32(p)``."""
    return uniform(k, shape) < torch.tensor(p, dtype=torch.float32,
                                            device=k.device)
