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


# XLA:CPU's float32 log, log1p and lgamma, reproduced step for step
# (`prng.log_f32`, `log1p_f32`, `lgamma_f32`): equal on every input tried.
@pytest.mark.parametrize("exponent", [-126, -100, -24, -2, -1, 0, 1, 7, 60,
                                      127])
def test_log_f32_matches_xla_on_every_mantissa(exponent):
    bits = (np.uint32(127 + exponent) << 23) | np.arange(
        1 << 23, dtype=np.uint32)
    x = bits.view(np.float32)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = prng.log_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_log_f32_special_values_match_xla():
    x = np.array([0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, 1e-40, 1e-38,
                  2.0 ** -126, 1.0, 3.4e38], np.float32)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = prng.log_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(want[ok], got[ok])


def test_log1p_and_lgamma_f32_match_xla():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-0.5, 0.5, 400_001, dtype=np.float32),
                        rng.uniform(-0.99, 1e3, 400_000).astype(np.float32)])
    np.testing.assert_array_equal(
        np.asarray(jnp.log1p(jnp.asarray(x))).view(np.int32),
        prng.log1p_f32(torch.from_numpy(x)).numpy().view(np.int32))
    g = np.concatenate([np.arange(1, 20_000, dtype=np.float32),
                        rng.uniform(0.5, 1e5, 400_000).astype(np.float32)])
    np.testing.assert_array_equal(
        np.asarray(jax.lax.lgamma(jnp.asarray(g))).view(np.int32),
        prng.lgamma_f32(torch.from_numpy(g)).numpy().view(np.int32))


@pytest.mark.parametrize("shape", [(1,), (5000,), (33, 9)])
def test_gumbel_matches_jax(shape):
    for seed in SEEDS:
        jk, tk = _pair(seed)
        want = np.asarray(jax.random.gumbel(jk, shape))
        got = prng.gumbel(tk, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.numpy().view(np.int32))


# `jax.random.poisson` on a float32 scalar rate: Knuth below 10, Hörmann's
# rejection from 10 on, 0 at 0.
POISSON_RATES = (0.0, 0.5, 3.0, 9.99, 10.0, 200.0, 241.0, 1e4)


def poisson_mismatches(rate: float, n_keys: int) -> int:
    """How many of `n_keys` keys (split from key(0)) give the port a
    different `poisson` draw from jax's."""
    keys = jax.random.split(jax.random.key(0), n_keys)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.poisson(k, jnp.float32(rate)))(keys))
    words = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    lam = torch.tensor(rate, dtype=torch.float32)
    got = [int(prng.poisson(torch.from_numpy(w), lam)) for w in words]
    return int((np.asarray(got) != want).sum())


@pytest.mark.parametrize("rate", POISSON_RATES)
def test_poisson_matches_jax(rate):
    assert poisson_mismatches(rate, 125) == 0


def test_poisson_returns_int32_scalar_on_the_keys_device():
    out = prng.poisson(prng.key(3, "cpu"), torch.tensor(200.0))
    assert out.dtype == torch.int32 and out.shape == ()


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_prng.py
    # The poisson mismatch count over 1000 keys per rate (~1 min on the
    # CPU; not part of the test run).
    import json

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({str(rate): poisson_mismatches(rate, 1000)
                      for rate in POISSON_RATES}))
