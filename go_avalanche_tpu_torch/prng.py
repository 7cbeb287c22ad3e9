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
  * `randint`, `uniform`, `bernoulli`, `normal`, `gumbel` and
    `poisson` follow jax's recipes (`jax/_src/random.py`) step for step;
    `normal` evaluates XLA's single-precision `erf_inv` polynomial, not
    `torch.erfinv`, and `gumbel` and `poisson` take their logarithms
    from `log_f32`, XLA:CPU's own float32 `log` (`lgamma_f32` and
    `log1p_f32` likewise), so they give jax's CPU bits on the CPU and on
    the card alike.

All uint32 arithmetic runs in int64 masked to 32 bits: torch has no
shifts or adds on uint32 tensors on the CPU.  Everything stays on the
key's device; nothing syncs with the host.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from go_avalanche_tpu_torch import sync

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device="cuda") -> torch.Tensor:
    """`jax.random.key(seed)` as its two key words, ``[0, seed]``: with
    64-bit mode off (jax's default) the seed is a 32-bit value, so the
    port takes seeds in [0, 2**32) only."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.arange(2, dtype=torch.int64, device=device) * seed


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
    counter = (torch.arange(2, dtype=torch.int64, device=k.device)
               * (int(data) & _M32))
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
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=bits.device)
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
    return torch.full((), math.sqrt(2), dtype=torch.float32,
                      device=bits.device) * erf_inv(u)


def bernoulli(k: torch.Tensor, p: float,
              shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bernoulli` (mode 'low'): ``uniform < float32(p)``."""
    return uniform(k, shape) < torch.full((), p, dtype=torch.float32,
                                          device=k.device)


# XLA:CPU's float32 `log` (a Cephes polynomial in three chains), read off
# the LLVM IR and the machine code it emits for `jnp.log`: each constant
# is the float32 value, each step one float32 operation or one fused
# multiply-add where the machine code has one.
_LOG_SQRTHF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1, _LOG_Q2 = -0.00021219444170128554, 0.693359375
_MIN_NORMAL = 2.0 ** -126


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA:CPU's fused
    multiply-add gives it: the product of two float32 values is exact
    in float64, the sum is rounded there and then to float32."""
    def wide(x):
        return x.double() if isinstance(x, torch.Tensor) else x

    return (wide(a) * wide(b) + wide(c)).float()


def _over(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as one IEEE division (torch spells ``scalar / tensor``
    as a reciprocal and a multiply, two roundings)."""
    return torch.full_like(x, c) / x


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 natural log, bit for bit: the input clamped to
    the smallest normal, split into a mantissa in [sqrt(1/2), sqrt(2))
    and an exponent, a degree-9 polynomial in three chains, and the
    exponent's ln 2 added in two parts, with XLA's fused multiply-adds
    where LLVM contracts them (`_fma`).  XLA:CPU reads a subnormal input
    as 0: 0 and subnormals give -inf, +inf gives +inf, a negative or NaN
    input NaN.  Every other step is one float32 operation, so the CPU and
    the card give the same bits."""
    x = x.to(torch.float32)
    xc = torch.where(x > _MIN_NORMAL, x,
                     torch.full_like(x, _MIN_NORMAL))
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _LOG_SQRTHF
    zero = torch.zeros_like(m)
    r = (m - 1.0) + torch.where(small, m, zero)
    e = e - torch.where(small, torch.ones_like(m), zero)
    z = r * r
    r3 = z * r
    p = _LOG_P
    y0 = _fma(_fma(r, p[0], p[1]), r, p[2])
    y1 = _fma(_fma(r, p[3], p[4]), r, p[5])
    y2 = _fma(_fma(r, p[6], p[7]), r, p[8])
    y = _fma(_fma(_fma(y0, r3, y1), r3, y2), r3, e * _LOG_Q1)
    out = ((r - z * 0.5) + y) + e * _LOG_Q2
    out = torch.where((x > 0) | (x == 0), out,
                      torch.full_like(out, math.nan))
    out = torch.where((x >= 0) & (x < _MIN_NORMAL),
                      torch.full_like(out, -math.inf), out)
    return torch.where(x == math.inf, x, out)


# XLA:CPU's float32 `log1p` below |x| < sqrt(2) - 1: x - x^2/2 + x^3 N/D,
# N and D degree-6 polynomials.
_LOG1P_N = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
            29.91191864013672, 60.949668884277344, 57.11296463012695,
            20.039552688598633)
_LOG1P_D = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
            309.0987243652344, 216.42788696289062, 60.11865997314453)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 `log1p`, bit for bit: a rational form where
    |x| < 0.41421357, else `log_f32(1 + x)`."""
    x = x.to(torch.float32)
    x2 = x * x
    num = torch.full_like(x, _LOG1P_N[0])
    den = torch.ones_like(x)
    for cn, cd in zip(_LOG1P_N[1:], _LOG1P_D[1:]):
        num = _fma(num, x, cn)
        den = _fma(den, x, cd)
    near = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < 0.4142135679721832, near,
                       log_f32(x + 1.0))


# XLA's float32 `lgamma` (Lanczos, g = 7), as XLA:CPU evaluates it.
_LANCZOS = (676.5203857421875, -1259.13916015625, 771.3234252929688,
            -176.6150360107422, 12.507343292236328, -0.138571098446846,
            9.984369171434082e-06, 1.5056326674312004e-07)
_LOG_LANCZOS_G_HALF = 2.0149030685424805    # log(7.5)
_INV_LANCZOS_G_HALF = 0.13333334028720856   # 1 / 7.5, as XLA folds it
_LOG_SQRT_2PI = 0.9189385175704956


def lgamma_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 `lgamma` for x >= 0.5, bit for bit: the Lanczos
    sum, ``log(t)`` as ``log(7.5) + log1p(z / 7.5)`` and ``(z + 1/2 -
    t / log t) * log t + log(sqrt(2 pi)) + log(sum)``.  Below 0.5 XLA
    reflects through its own `sin`; there the value is float64 `lgamma`
    rounded once (`poisson` reads it only where it rejects anyway).
    +-inf gives +inf."""
    x = x.to(torch.float32)
    z = x - 1.0
    a = _over(_LANCZOS[0], z + 1.0) + 1.0
    for i, c in enumerate(_LANCZOS[1:], start=2):
        term = _over(abs(c), z + float(i))
        a = a - term if c < 0 else term + a
    t = z + 7.5
    log_t = log1p_f32(z * _INV_LANCZOS_G_HALF) + _LOG_LANCZOS_G_HALF
    out = _fma(log_t, (z + 0.5) - t / log_t, _LOG_SQRT_2PI) + log_f32(a)
    reflected = torch.lgamma(x.double()).float()
    out = torch.where(x < 0.5, reflected, out)
    return torch.where(x.abs() == math.inf, x.abs(), out)


_F32_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.gumbel` (mode 'low') in float32: ``-log(-log(u))``
    with `u` uniform on [tiny, 1), both logs XLA:CPU's (`log_f32`)."""
    u = uniform(k, shape, _F32_TINY, 1.0)
    return -log_f32(-log_f32(u))


def _uniform_scalars(keys: torch.Tensor) -> torch.Tensor:
    """`uniform(key, ())` for each row of ``[K, 2]`` `keys`, in one
    hash: float32 ``[K]``."""
    zero = torch.zeros(keys.shape[0], dtype=torch.int64,
                       device=keys.device)
    b0, b1 = threefry2x32(keys.t(), zero, zero)
    return bits_to_uniform(b0 ^ b1)


def _poisson_knuth(k: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Knuth's multiplication method as jax runs it (lam < 10): one
    split and one uniform per iteration, the log-product summed in
    float32, and the loop read back once an iteration."""
    neg_lam = -lam
    log_prod = torch.zeros_like(lam)
    count = 0
    rng = k
    while sync.read(log_prod > neg_lam):
        rng, sub = split(rng)
        count += 1
        log_prod = log_prod + log_f32(_uniform_scalars(sub[None])[0])
    return torch.full((), count - 1, dtype=torch.int32, device=k.device)


def _poisson_rejection(k: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Hörmann's transformed rejection as jax runs it (lam >= 10): one
    three-way split and two uniforms per iteration until one draw is
    accepted, read back once an iteration."""
    log_lam = log_f32(lam)
    b = _fma(torch.sqrt(lam), 2.53, 0.931)
    a = _fma(b, 0.02483, -0.059)
    inv_alpha = _over(1.1328, b - 3.4) + 1.1239
    v_r = 0.9277 - _over(3.6224, b - 2.0)
    key = k
    while True:
        key, sub0, sub1 = split(key, 3)
        u, v = _uniform_scalars(torch.stack([sub0, sub1]))
        u = u - 0.5
        us = 0.5 - u.abs()
        draw = torch.floor(_fma((a * 2.0) / us + b, u, lam) + 0.43)
        s = log_f32(v * inv_alpha / (a / (us * us) + b))
        t = _fma(draw, log_lam, -lam) - lgamma_f32(draw + 1.0)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (draw < 0) | ((us < 0.013) & (v > us))
        if sync.read(accept1 | (~reject & (s <= t))):
            return draw.to(torch.int32)


def poisson(k: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """`jax.random.poisson(key, lam)` for a float32 scalar rate: int32
    scalar on the key's device.  Knuth below 10 (or NaN), Hörmann's
    rejection from 10 on, 0 where `lam` is 0 — jax's dispatch, with its
    key use and its float32 steps (`log_f32`, `lgamma_f32`).  The rate
    is read back once to pick the branch; each iteration of the chosen
    loop is read back once more (`sync.reads`)."""
    lam = lam.to(torch.float32)
    rate = sync.read(lam)
    if rate == 0.0:
        return torch.zeros((), dtype=torch.int32, device=k.device)
    if math.isnan(rate) or rate < 10.0:
        return _poisson_knuth(k, lam)
    return _poisson_rejection(k, lam)
