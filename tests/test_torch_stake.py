"""The port's stake vector and stake-weighted avalanche rounds against
the JAX reference.

`node_stake` is compared leaf by leaf: exactly for "uniform", "explicit"
and zipf exponent 1 (a division), and within a stated ulp distance for
other zipf exponents, where torch's `pow` and XLA's round differently.
The trajectories start from one JAX state carried across (its
`latency_weight` already holds the stake) and must be equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu import stake as jstake
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu_torch import prng, stake
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as tav
from test_torch_avalanche import _jax_numpy, run_both

# Largest float32 distance, in ulp, between the port's ``1 / (i + 1) ** s``
# (the power in float64, rounded once) and XLA:CPU's float32 one, over the
# exponents below at 100000 nodes.
ZIPF_MAX_ULP = 2


def _ulp_distance(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("knobs", [
    dict(stake_mode="off"), dict(stake_mode="uniform"),
    dict(stake_mode="zipf"),
    dict(stake_mode="explicit", stake_weights=(3.0, 1.0, 0.5, 2.0, 7.25)),
])
def test_node_stake_matches_jax_exactly(knobs):
    jcfg, tcfg = JaxConfig(**knobs), AvalancheConfig(**knobs)
    want = jstake.node_stake(jcfg, 5)
    got = stake.node_stake(tcfg, 5, device="cpu")
    assert stake.stake_enabled(tcfg) == jstake.stake_enabled(jcfg)
    if want is None:
        assert got is None
        return
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("s", [0.5, 0.8, 1.1, 1.5, 2.0, 3.0])
def test_node_stake_zipf_within_stated_ulp(s):
    n = 100_000
    want = np.asarray(jstake.node_stake(JaxConfig(stake_mode="zipf",
                                                  stake_zipf_s=s), n))
    got = stake.node_stake(AvalancheConfig(stake_mode="zipf",
                                           stake_zipf_s=s), n,
                           device="cpu").numpy()
    assert int(_ulp_distance(want, got).max()) <= ZIPF_MAX_ULP


def test_explicit_stake_length_is_checked():
    cfg = AvalancheConfig(stake_mode="explicit", stake_weights=(1.0, 2.0))
    with pytest.raises(ValueError, match="one stake per node"):
        stake.node_stake(cfg, 3, device="cpu")


@pytest.mark.parametrize("knobs", [
    dict(stake_mode="explicit", stake_weights=(0.0,)),
    dict(stake_mode="zipf", stake_zipf_s=-1.0),
    dict(stake_zipf_s=2.0),
    dict(stake_weights=(1.0,)),
    dict(stake_mode="explicit"),
    dict(stake_mode="bogus"),
    dict(stake_mode="uniform", sample_with_replacement=False),
    dict(weighted_sampling=True, sample_with_replacement=False),
    dict(n_clusters=0),
    dict(n_clusters=2, sample_with_replacement=False),
    dict(cluster_locality=1.5),
])
def test_sampling_and_stake_config_errors_match_jax(knobs):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**knobs)
    with pytest.raises(ValueError) as terr:
        AvalancheConfig(**knobs)
    assert str(terr.value) == str(jerr.value)


def test_init_folds_stake_into_latency_weight_as_jax_does():
    from go_avalanche_tpu.models import avalanche as jav

    knobs = dict(stake_mode="zipf", stake_zipf_s=1.0)
    lw = np.random.default_rng(0).random(40).astype(np.float32) + 0.5
    jstate = jav.init(jax.random.key(0), 40, 16, JaxConfig(**knobs),
                      latency_weights=lw)
    tstate = tav.init(prng.key(0, "cpu"), 40, 16, AvalancheConfig(**knobs),
                      latency_weights=torch.from_numpy(lw), device="cpu")
    np.testing.assert_array_equal(np.asarray(jstate.latency_weight),
                                  tstate.latency_weight.numpy())


@pytest.mark.parametrize("knobs", [
    dict(stake_mode="zipf"),
    dict(stake_mode="zipf", n_clusters=4, byzantine_fraction=0.2),
    dict(stake_mode="uniform", churn_probability=0.05),
])
def test_stake_trajectory_matches_jax(knobs):
    state = run_both(dict(knobs, max_element_poll=64), 64, 64, 6, seed=5,
                     contested=True)
    assert int(state.round) == 6


@pytest.mark.parametrize("mode", ["zipf", "uniform", "masked", "zero_stake",
                                  "short_pool"])
def test_draw_working_set_matches_jax(mode):
    """Gumbel top-k: the same ids in the same order, and the same `valid`
    lanes where the pool runs short (-inf scores, in id order)."""
    r, w = 300, 40
    cfg = JaxConfig(stake_mode="uniform" if mode == "uniform" else "zipf")
    stake_r = np.array(jstake.node_stake(cfg, r))
    mask = None
    if mode == "masked":
        mask = np.random.default_rng(0).random(r) < 0.6
    if mode == "zero_stake":
        stake_r = stake_r.copy()
        stake_r[::3] = 0.0
    if mode == "short_pool":
        mask = np.zeros(r, bool)
        mask[:25] = True
    for seed in range(12):
        jk, tk = jax.random.key(seed), prng.key(seed, "cpu")
        want = jstake.draw_working_set(
            jk, stake_r, w, mask=None if mask is None else jnp.asarray(mask))
        got = stake.draw_working_set(
            tk, torch.from_numpy(stake_r), w,
            mask=None if mask is None else torch.from_numpy(mask),
            device="cpu")
        for wv, gv in zip(want, got):
            np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
        assert got[0].dtype == torch.int32
