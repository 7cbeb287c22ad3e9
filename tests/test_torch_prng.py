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
