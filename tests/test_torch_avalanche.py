"""Whole-trajectory parity of the port's `round_step` with the JAX one.

Both packages start from ONE state (the JAX `init`, carried over with
`convert.state_from_numpy`) and run the same rounds; every state leaf
and every per-round telemetry scalar must be equal.  Tolerance 0.
"""

import jax
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.config import VoteMode as JaxVoteMode
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.config import (AdversaryStrategy, AvalancheConfig,
                                           VoteMode)
from go_avalanche_tpu_torch.models import avalanche as tav

# `benchmarks/workload.flagship_config`'s values.
FLAGSHIP = dict(finalization_score=0x7FFE, k=8, gossip=False,
                max_element_poll=4096)
# tests/test_cross_backend_parity.py's config.
CROSS_BACKEND = dict(byzantine_fraction=0.2, drop_probability=0.05,
                     adversary_strategy="equivocate")


def _configs(knobs):
    jkw, tkw = dict(knobs), dict(knobs)
    if "adversary_strategy" in knobs:
        jkw["adversary_strategy"] = JaxStrategy(knobs["adversary_strategy"])
        tkw["adversary_strategy"] = AdversaryStrategy(
            knobs["adversary_strategy"])
    if "vote_mode" in knobs:
        jkw["vote_mode"] = JaxVoteMode(knobs["vote_mode"])
        tkw["vote_mode"] = VoteMode(knobs["vote_mode"])
    return JaxConfig(**jkw), AvalancheConfig(**tkw)


def _np(x):
    if x is None:
        return None
    if jax.dtypes.issubdtype(getattr(x, "dtype", None), jax.dtypes.prng_key):
        x = jax.random.key_data(x)
    return np.asarray(x)


def _jax_numpy(state):
    return jax.tree.map(_np, state, is_leaf=lambda x: x is None)


def assert_states_equal(jstate, tstate, where):
    want = _jax_numpy(jstate)
    got = convert.state_to_numpy(tstate)
    for field in got._fields:
        if field == "records":
            for leaf in ("votes", "consider", "confidence"):
                w = getattr(want.records, leaf)
                g = getattr(got.records, leaf)
                assert w.dtype == g.dtype, (where, leaf)
                np.testing.assert_array_equal(w, g, err_msg=f"{where} {leaf}")
            continue
        assert_leaves_equal(getattr(want, field), getattr(got, field),
                            f"{where} {field}")


def assert_leaves_equal(want, got, where):
    """Two numpy trees (nested NamedTuples, None leaves) equal leaf by
    leaf, dtypes included."""
    if want is None:
        assert got is None, where
        return
    if isinstance(want, tuple):
        assert type(want).__name__ == type(got).__name__, where
        for name in want._fields:
            assert_leaves_equal(getattr(want, name), getattr(got, name),
                                f"{where}.{name}")
        return
    assert want.dtype == got.dtype, (where, want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=where)


def run_both(knobs, n, t, rounds, seed=7, contested=False):
    jcfg, tcfg = _configs(knobs)
    pref = jav.contested_init_pref(seed, n, t) if contested else None
    jstate = jav.init(jax.random.key(seed), n, t, jcfg, init_pref=pref)
    tstate = convert.state_from_numpy(_jax_numpy(jstate), device="cpu")
    assert_states_equal(jstate, tstate, "init")
    for r in range(rounds):
        jstate, jtel = jav.round_step(jstate, jcfg)
        tstate, ttel = tav.round_step(tstate, tcfg)
        for field in jtel._fields:
            assert int(getattr(jtel, field)) == int(getattr(ttel, field)), (
                r, field)
    assert_states_equal(jstate, tstate, f"round {rounds}")
    return tstate


@pytest.mark.parametrize("engine", ["phased", "megakernel"])
def test_flagship_trajectory_matches_jax(engine):
    run_both(dict(FLAGSHIP, round_engine=engine), 256, 256, 4)


@pytest.mark.parametrize("engine", ["phased", "megakernel"])
def test_flagship_workload_matches_reference_bench(engine):
    from benchmarks import workload as jwl
    from go_avalanche_tpu_torch import workload as twl

    jstate, _ = jwl.flagship_state(64, 256)
    jcfg = jwl.flagship_config(256, round_engine=engine)
    tstate, tcfg = twl.flagship_state(64, 256, round_engine=engine,
                                      device="cpu")
    for field in tcfg.__dataclass_fields__:
        want, got = getattr(jcfg, field), getattr(tcfg, field)
        assert getattr(want, "value", want) == getattr(got, "value", got), \
            field
    assert_states_equal(jstate, tstate, "flagship init")


def test_cross_backend_config_trajectory_matches_jax():
    state = run_both(CROSS_BACKEND, 64, 32, 40)
    assert int(state.round) == 40


@pytest.mark.parametrize("engine", ["phased", "megakernel"])
def test_contested_oppose_churn_trajectory_matches_jax(engine):
    run_both(dict(byzantine_fraction=0.2, adversary_strategy="oppose_majority",
                  churn_probability=0.02, max_element_poll=100,
                  round_engine=engine), 64, 256, 6, seed=3, contested=True)


SWAR32_CASES = {
    "flagship": (dict(FLAGSHIP), 256, 256, 4, False),
    "cross_backend": (dict(CROSS_BACKEND), 64, 32, 20, False),
    "contested_oppose_churn": (dict(byzantine_fraction=0.2,
                                    adversary_strategy="oppose_majority",
                                    churn_probability=0.02,
                                    max_element_poll=100), 64, 256, 6, True),
    "ragged_small_window": (dict(window=5, quorum=4, finalization_score=8),
                            32, 10, 8, False),
    "skip_absent_legacy": (dict(drop_probability=0.3, skip_absent_votes=True,
                                fused_exchange=False), 48, 40, 8, False),
}


@pytest.mark.parametrize("case", sorted(SWAR32_CASES))
def test_swar32_phased_trajectory_matches_jax(case):
    knobs, n, t, rounds, contested = SWAR32_CASES[case]
    run_both(dict(knobs, ingest_engine="swar32"), n, t, rounds, seed=11,
             contested=contested)


def test_majority_legacy_exchange_trajectory_matches_jax():
    run_both(dict(vote_mode="majority", fused_exchange=False), 48, 40, 10)


def test_contested_init_pref_matches_jax():
    want = np.asarray(jav.contested_init_pref(5, 17, 29))
    np.testing.assert_array_equal(
        want, tav.contested_init_pref(5, 17, 29, device="cpu").numpy())


def test_run_and_run_scan_settle_like_jax():
    jcfg, tcfg = _configs(dict(k=8))
    jstate = jav.init(jax.random.key(1), 16, 8, jcfg)
    tstate = convert.state_from_numpy(_jax_numpy(jstate), device="cpu")
    jfinal = jav.run(jstate, jcfg, max_rounds=60)
    tfinal = tav.run(tstate, tcfg, max_rounds=60, device="cpu")
    assert_states_equal(jfinal, tfinal, "run")
    _, jtel = jav.run_scan(jstate, jcfg, n_rounds=5)
    _, ttel = tav.run_scan(tstate, tcfg, n_rounds=5, device="cpu")
    for field in jtel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jtel, field)),
                                      getattr(ttel, field).numpy())


def test_capped_poll_mask_matches_jax():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 5, 40).astype(np.int32)
    pollable = rng.random((6, 40)) < 0.6
    rank, order, inv = jav.score_rank_with_orders(jax.numpy.asarray(scores))
    want = jav.capped_poll_mask(jax.numpy.asarray(pollable), rank, 7, order,
                                inv)
    trank, torder, tinv = tav.score_rank_with_orders(torch.from_numpy(scores))
    np.testing.assert_array_equal(np.asarray(rank), trank.numpy())
    np.testing.assert_array_equal(np.asarray(order), torder.numpy())
    got = tav.capped_poll_mask(torch.from_numpy(pollable), 7, torder, tinv)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
