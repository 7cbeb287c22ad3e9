"""The port's peer exchange and gossip admission against the JAX reference.

Fused == legacy == JAX for the vote packs under every static adversary
strategy, and for the gossip scatter with duplicate peer draws (which
must OR, not overwrite).  Tolerance 0: uint8 planes compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.ops import bitops as jbits
from go_avalanche_tpu.ops import exchange as jex
from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.ops import bitops, exchange

STRATEGIES = ["flip", "oppose_majority", "equivocate"]


@pytest.mark.parametrize("t", [1, 8, 13, 64])
def test_pack_unpack_match_jax(t):
    rng = np.random.default_rng(t)
    x = rng.random((5, 3, t)) < 0.5
    packed = bitops.pack_bool_plane(torch.from_numpy(x))
    np.testing.assert_array_equal(
        np.asarray(jbits.pack_bool_plane(jnp.asarray(x))), packed.numpy())
    np.testing.assert_array_equal(bitops.unpack_bool_plane(packed, t).numpy(),
                                  x)
    b = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(jbits.popcount8(jnp.asarray(b))),
        bitops.popcount8(torch.from_numpy(b)).numpy())


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [3, 8])
def test_vote_packs_fused_legacy_jax_agree(strategy, k):
    kw = dict(k=k, byzantine_fraction=0.3)
    jcfg = JaxConfig(adversary_strategy=JaxStrategy(strategy), **kw)
    tcfg = AvalancheConfig(adversary_strategy=AdversaryStrategy(strategy),
                           **kw)
    rng = np.random.default_rng(k)
    n, t = 20, 37
    prefs = rng.random((n, t)) < 0.5
    peers = rng.integers(0, n, (n, k)).astype(np.int32)
    responded = rng.random((n, k)) < 0.8
    lie = rng.random((n, k)) < 0.4
    minority = rng.random(t) < 0.5
    seed = 11 + k
    jargs = (jbits.pack_bool_plane(jnp.asarray(prefs)), jnp.asarray(peers),
             jnp.asarray(responded), jnp.asarray(lie), jax.random.key(seed),
             jcfg, jnp.asarray(minority), t)
    targs = (bitops.pack_bool_plane(torch.from_numpy(prefs)),
             torch.from_numpy(peers), torch.from_numpy(responded),
             torch.from_numpy(lie), prng.key(seed, device="cpu"), tcfg,
             torch.from_numpy(minority), t)
    want = [np.asarray(x) for x in jex.fused_vote_packs(*jargs)]
    for engine in (exchange.fused_vote_packs, exchange.legacy_vote_packs):
        got = engine(*targs)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("t", [16, 21])
def test_gossip_heard_with_duplicate_draws(t):
    rng = np.random.default_rng(t)
    n, k = 12, 6
    peers = rng.integers(0, 4, (n, k)).astype(np.int32)   # many duplicates
    polled = (rng.random((n, t)) < 0.3).astype(np.uint8)
    want = np.asarray(jex.fused_gossip_heard(jnp.asarray(peers),
                                             jnp.asarray(polled)))
    np.testing.assert_array_equal(
        want, np.asarray(jex.legacy_gossip_heard(jnp.asarray(peers),
                                                 jnp.asarray(polled))))
    tp, tpol = torch.from_numpy(peers), torch.from_numpy(polled)
    for fused in (True, False):
        got = exchange.gossip_heard(tp, tpol,
                                    AvalancheConfig(fused_exchange=fused))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(want, got.numpy())
