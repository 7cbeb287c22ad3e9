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
  * `randint`, `uniform`, `bernoulli` and `normal` follow jax's
    recipes (`jax/_src/random.py`) step for step; `normal` evaluates
    XLA's single-precision `erf_inv` polynomial, not `torch.erfinv`.

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


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` on [minval, maxval) in float32: the top 23
    bits become the mantissa of a float in [1, 2), minus one, then
    ``max(minval, f * (maxval - minval) + minval)`` with the bounds in
    float32.  XLA contracts the scale and the shift into one fused
    multiply-add (one rounding), which float64 reproduces: the product
    of two float32 values is exact there."""
    return bits_to_uniform(random_bits(k, shape), minval, maxval)


def bits_to_uniform(bits: torch.Tensor, minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """`uniform`'s map from 32 random bits (uint32 values in int64) to
    a float32 in [minval, maxval); only the top 23 bits are read."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    scaled = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


# `normal`'s uniform draws lie in [nextafter(-1, 0), 1).
NORMAL_LOW = -1.0 + 2.0 ** -24

# XLA's single-precision erf_inv (Giles' polynomial in w = -log1p(-x^2),
# one coefficient set for w < 5 and one for the tail).
_ERF_INV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `erf_inv`, step for step, each Horner step a fused
    multiply-add as XLA contracts it (float64 product and sum, one
    rounding to float32).  Its `log1p` and `sqrt` are taken in float64
    and rounded once, so the CPU and the card give the same bits; they
    round some inputs differently from XLA:CPU's own approximations, and
    `tests/test_torch_prng.py` states the largest distance that leaves
    in `normal`."""
    w = -torch.log1p((x * -x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5,
                    torch.sqrt(w.double()).float() - 3.0).double()

    def coefficient(i: int) -> torch.Tensor:
        return torch.where(small, _ERF_INV_SMALL[i], _ERF_INV_TAIL[i])

    p = coefficient(0)
    for i in range(1, len(_ERF_INV_SMALL)):
        p = (coefficient(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.normal` in float32: ``sqrt(2) * erf_inv(u)`` with `u`
    uniform on ``[nextafter(-1, 0), 1)``."""
    return bits_to_normal(random_bits(k, shape))


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """`normal`'s map from 32 random bits to a float32."""
    u = bits_to_uniform(bits, NORMAL_LOW, 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32,
                        device=bits.device) * erf_inv(u)


def bernoulli(k: torch.Tensor, p: float,
              shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bernoulli` (mode 'low'): ``uniform < float32(p)``."""
    return uniform(k, shape) < torch.tensor(p, dtype=torch.float32,
                                            device=k.device)
