"""The port's peer samplers against the JAX reference's, bit for bit.

Each sampler gets the same key and the same float32 weights (made with
numpy from a seed) in both packages; every drawn id must be equal.
`cumsum_f32` must equal `jnp.cumsum` on the CPU bit for bit, since the
inverse-CDF samplers search that sum.  Tolerance 0 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.ops import sampling as jsm
from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.ops import sampling as tsm

SEEDS = [0, 1, 7, 42, 99, 1234, 65537, 2**31 + 5]


def _weights(n, seed=0, dead=0.0):
    rng = np.random.default_rng(seed)
    w = np.exp(rng.normal(size=n) * 0.5).astype(np.float32)
    if dead:
        w[rng.random(n) < dead] = 0.0
    return w


def _keys(seed):
    return jax.random.key(seed), prng.key(seed, device="cpu")


@pytest.mark.parametrize("n", [1, 15, 16, 17, 256, 257, 4096, 100000])
def test_cumsum_f32_matches_jnp_cumsum(n):
    for seed in (0, 1):
        w = _weights(n, seed, dead=0.1)
        want = np.asarray(jnp.cumsum(jnp.asarray(w)))
        got = tsm.cumsum_f32(torch.from_numpy(w)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("c,n", [(1, 100), (4, 1000), (7, 513), (3, 4097)])
def test_cumsum_f32_rows_match_jnp_cumsum_axis1(c, n):
    w = np.stack([_weights(n, seed) for seed in range(c)])
    want = np.asarray(jnp.cumsum(jnp.asarray(w), axis=1))
    np.testing.assert_array_equal(want,
                                  tsm.cumsum_f32(torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("n,k,excl", [(20, 8, True), (9, 8, True),
                                      (8, 8, False), (300, 5, True),
                                      (1000, 8, False)])
def test_distinct_matches_jax(n, k, excl):
    for seed in SEEDS:
        jk, tk = _keys(seed)
        want = np.asarray(jsm.sample_peers_distinct(jk, n, k, excl))
        got = tsm.sample_peers_distinct(tk, n, k, excl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())
        rows = np.sort(got.numpy(), axis=1)
        assert (np.diff(rows, axis=1) > 0).all()


def test_distinct_rejects_a_pool_smaller_than_k():
    with pytest.raises(ValueError, match="distinct"):
        tsm.sample_peers_distinct(prng.key(0, "cpu"), 8, 8, True)


@pytest.mark.parametrize("n,rows,k", [(100, 100, 8), (1000, 333, 4),
                                      (4099, 64, 8)])
def test_weighted_matches_jax(n, rows, k):
    w = _weights(n, n, dead=0.05)
    for seed in SEEDS:
        jk, tk = _keys(seed)
        want = np.asarray(jsm.sample_peers_weighted(jk, jnp.asarray(w),
                                                    rows, k))
        got = tsm.sample_peers_weighted(tk, torch.from_numpy(w), rows, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("c", [1, 4, 7])
@pytest.mark.parametrize("n", [100, 1001])
def test_hierarchical_matches_jax_and_weighted(c, n):
    w = _weights(n, c, dead=0.05)
    for seed in SEEDS:
        jk, tk = _keys(seed)
        want = np.asarray(jsm.sample_peers_hierarchical(
            jk, jnp.asarray(w), n, 8, c))
        got = tsm.sample_peers_hierarchical(tk, torch.from_numpy(w), n, 8, c)
        np.testing.assert_array_equal(want, got.numpy())
        flat = tsm.sample_peers_weighted(tk, torch.from_numpy(w), n, 8)
        np.testing.assert_array_equal(flat.numpy(), got.numpy())


def test_hierarchical_rejects_more_clusters_than_nodes():
    with pytest.raises(ValueError, match="n_clusters"):
        tsm.sample_peers_hierarchical(prng.key(0, "cpu"), torch.ones(4), 4,
                                      2, 5)


@pytest.mark.parametrize("c,locality", [(2, 0.8), (4, 0.8), (7, 0.5),
                                        (3, 1.0), (5, 0.0)])
def test_clustered_matches_jax(c, locality):
    n = 301
    w = _weights(n, c, dead=0.05)
    for seed in SEEDS:
        jk, tk = _keys(seed)
        want = np.asarray(jsm.sample_peers_clustered(
            jk, jnp.asarray(w), n, 8, c, locality))
        got = tsm.sample_peers_clustered(tk, torch.from_numpy(w), n, 8, c,
                                         locality)
        np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("c,n", [(1, 10), (3, 10), (7, 1000), (4, 4)])
def test_cluster_ids_matches_jax_cluster_of(c, n):
    ids = np.arange(n, dtype=np.int32)
    want = np.asarray(jsm.cluster_of(jnp.asarray(ids), c, n))
    got = tsm.cluster_ids(torch.from_numpy(ids), c, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_self_sample_mask_matches_jax():
    peers = np.random.default_rng(3).integers(0, 12, (12, 8)).astype(np.int32)
    want = np.asarray(jsm.self_sample_mask(jnp.asarray(peers)))
    got = tsm.self_sample_mask(torch.from_numpy(peers))
    np.testing.assert_array_equal(want, got.numpy())
    assert want.any()


DRAW_FAMILIES = {
    "uniform": dict(),
    "uniform_with_self": dict(exclude_self=False),
    "distinct": dict(sample_with_replacement=False),
    "weighted": dict(weighted_sampling=True),
    "clustered": dict(n_clusters=3, cluster_locality=0.7),
    "stake_flat": dict(stake_mode="zipf", stake_zipf_s=1.0),
    "stake_hierarchical": dict(stake_mode="uniform", n_clusters=4),
}


@pytest.mark.parametrize("family", list(DRAW_FAMILIES))
def test_draw_peers_matches_jax(family):
    knobs = DRAW_FAMILIES[family]
    jcfg, tcfg = JaxConfig(k=6, **knobs), AvalancheConfig(k=6, **knobs)
    n = 203
    w = _weights(n, 11)
    alive = np.random.default_rng(5).random(n) < 0.9
    for seed in SEEDS:
        jk, tk = _keys(seed)
        jp, jself = jsm.draw_peers(jk, jcfg, jnp.asarray(w),
                                   jnp.asarray(alive), n)
        tp, tself = tsm.draw_peers(tk, tcfg, torch.from_numpy(w),
                                   torch.from_numpy(alive), n)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        assert (jself is None) == (tself is None)
        if jself is not None:
            np.testing.assert_array_equal(np.asarray(jself), tself.numpy())
