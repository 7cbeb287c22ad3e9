"""The port's threefry PRNG against `jax.random`, bit for bit.

Tolerance 0: every comparison is of integer words or of float32 values
built from the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu_torch import prng

SEEDS = [0, 1, 2, 3, 5, 7, 11, 42, 99, 123, 255, 256, 1000, 4242, 65535,
         65536, 123456, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]


def _pair(seed):
    return jax.random.key(seed), prng.key(seed, device="cpu")


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_match_jax(seed):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    for num in (2, 5):
        np.testing.assert_array_equal(_words(jax.random.split(jk, num)),
                                      prng.split(tk, num).numpy())
    for data in (0, 0x5A, 0xC0, 2**32 - 1):
        np.testing.assert_array_equal(_words(jax.random.fold_in(jk, data)),
                                      prng.fold_in(tk, data).numpy())


@pytest.mark.parametrize("maxval", [2, 5, 63, 64, 1000, 16383, 70000,
                                    2**31 - 1])
def test_randint_matches_jax(maxval):
    for seed in SEEDS:
        jk, tk = _pair(seed)
        want = jax.random.randint(jk, (33, 8), 0, maxval, dtype=jnp.int32)
        got = prng.randint(tk, (33, 8), 0, maxval)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_randint_nonzero_minval_and_empty_span_match_jax():
    jk, tk = _pair(17)
    for lo, hi in ((-5, 9), (10, 10), (7, 3)):
        want = jax.random.randint(jk, (40,), lo, hi, dtype=jnp.int32)
        np.testing.assert_array_equal(np.asarray(want),
                                      prng.randint(tk, (40,), lo, hi).numpy())


@pytest.mark.parametrize("p", [0.0, 0.05, 0.5, 0.95, 1.0])
def test_bernoulli_matches_jax(p):
    for seed in SEEDS:
        jk, tk = _pair(seed)
        want = jax.random.bernoulli(jk, p, (17, 9))
        np.testing.assert_array_equal(np.asarray(want),
                                      prng.bernoulli(tk, p, (17, 9)).numpy())


@pytest.mark.parametrize("shape", [(1,), (5, 13), (3, 4, 7)])
def test_uniform_matches_jax(shape):
    for seed in SEEDS:
        jk, tk = _pair(seed)
        want = jax.random.uniform(jk, shape)
        got = prng.uniform(tk, shape)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", [-1, 2**32])
def test_key_rejects_seeds_outside_32_bits(seed):
    with pytest.raises(ValueError):
        prng.key(seed, device="cpu")


# Every 23-bit mantissa once: a PRNG whose random bits are ``i << 9`` for
# element i sends all 2**23 of them through jax's own `uniform` and
# `normal` (the low 9 bits are never read).
_MANTISSAS = 1 << 23


def _mantissa_key():
    from jax.extend import random as jex_random

    def bits(keys, bit_width, shape):
        assert bit_width == 32
        return jax.lax.iota(jnp.uint32, _MANTISSAS).reshape(shape) << 9

    def zeros(*_):
        return jnp.zeros((2,), jnp.uint32)

    impl = jex_random.define_prng_impl(
        key_shape=(2,), seed=zeros,
        split=lambda k, shape: jnp.zeros(shape + (2,), jnp.uint32),
        random_bits=bits, fold_in=lambda k, d: k, name="every_mantissa")
    return jax.random.key(0, impl=impl)


def _mantissa_bits():
    return torch.arange(_MANTISSAS, dtype=torch.int64) << 9


def _ulp_distance(a, b):
    """|a - b| in float32 units in the last place (sign-magnitude
    ordering, so -0 and +0 are 0 apart)."""
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (prng.NORMAL_LOW, 1.0)],
                         ids=["unit", "normal_range"])
def test_uniform_range_matches_jax_on_every_mantissa(lo, hi):
    want = np.asarray(jax.random.uniform(_mantissa_key(), (_MANTISSAS,),
                                         minval=lo, maxval=hi))
    got = prng.bits_to_uniform(_mantissa_bits(), lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want, got)


# The port's `normal` is XLA's erf_inv polynomial with float64-rounded
# log1p and sqrt; XLA:CPU's own log1p and sqrt round differently on some
# inputs, which leaves these gaps (a difference by design, ROADMAP.md
# Queue 3): at most 3 ulp, on under 1% of the mantissas.
NORMAL_MAX_ULP = 3
NORMAL_MAX_DIFFERING = 80_000


def test_normal_matches_jax_on_every_mantissa_within_stated_ulp():
    want = np.asarray(jax.random.normal(_mantissa_key(), (_MANTISSAS,)))
    got = prng.bits_to_normal(_mantissa_bits()).numpy()
    assert got.dtype == np.float32
    assert np.isfinite(got).all()
    dist = _ulp_distance(want, got)
    assert int(dist.max()) <= NORMAL_MAX_ULP
    assert int((dist > 0).sum()) <= NORMAL_MAX_DIFFERING


@pytest.mark.parametrize("shape", [(1,), (100000,), (33, 9)])
def test_normal_matches_jax_by_key_within_stated_ulp(shape):
    for seed in SEEDS[:8]:
        jk, tk = _pair(seed)
        want = np.asarray(jax.random.normal(jk, shape))
        got = prng.normal(tk, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert int(_ulp_distance(want, got.numpy()).max()) <= NORMAL_MAX_ULP
